"""tossctr_tpu_torch: the PyTorch / CUDA (H100) port of ``tossctr_tpu``.

It trains and serves the flagship DARE + QNN-alpha model: config, shard
cache, dense top-k selection, the model with hand-written sm_90a kernels
for the encoder (``ops/fused_attention.py``, ``ops/fused_ffn.py``) and the
QNN-alpha FM cross (``ops/fm_cross.py``), forward and backward, the
sparse-table train step, the K-fold loop (``train/trainer.py``
``train_main``), fold checkpoints (the port's format and the JAX
package's msgpack form), temperature calibration and fold ensembling.
It imports neither JAX nor ``tossctr_tpu``.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``.
"""
