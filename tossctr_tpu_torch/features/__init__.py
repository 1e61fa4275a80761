"""Features the ETL joins into the cache (port of ``tossctr_tpu/features``)."""

from .covis import CovisConfig, CovisJoiner, build_covis_features

__all__ = ["CovisConfig", "CovisJoiner", "build_covis_features"]
