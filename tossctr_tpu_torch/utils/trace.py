"""torch.profiler trace post-processing: per-op device-time budgets.

Counterpart of ``tossctr_tpu/utils/trace.py`` for a trace that
``torch.profiler`` exports (``prof.export_chrome_trace(path)``, a
``.json`` or ``.json.gz`` file): a profiled step window folded into the
JAX module's device-time classes, ``attention``, ``table_update``,
``select_gather``, ``sort``, ``matmul``, ``custom_call``,
``elementwise_fusion``, ``data_formatting`` and ``other``.
``chip_smoke.py``'s ``profile_step`` prints it for every profiled step.

Only the device's kernel, memcpy and memset events are summed.  Host
events (``cpu_op``, ``cuda_runtime``, ``user_annotation``, ...) and the
device's ``gpu_user_annotation`` spans, which cover the kernels inside a
``record_function`` range and would count them twice, are dropped, so a
plain sum is device time with no overlap on one stream.

A kernel event carries no shapes, so the JAX rules on output and operand
rows read the shapes of the ``cpu_op`` that launched the kernel (the two
share an ``External id``; profile with ``record_shapes=True``).  torch
records only input shapes: an op that writes its first input in place
(``aten::index_add_``, ``aten::copy_``, the ``_foreach_*_`` and
``_fused_*_`` optimizers, ...) has that input's rows as its output rows;
any other op's output rows count as 0.  An op whose output has >=
``big_rows`` rows is a table write; one with an operand of >= ``big_rows``
rows is a table gather.  Name rules stand in for XLA's ``hlo_category``.
The port's hand-written kernels go by their own name: ``mha_*`` to
``attention``, the table sweeps ``sweep_*`` to ``table_update``, the
others (the block tail, the FFN, the FM cross, ``reduce_partials``, the
dropout-mask dumps), which Pallas would have lowered to custom calls, to
``custom_call``.  Every other kernel goes by its name and its op's, in
the JAX module's order: the JAX regex (softmax, attention) to
``attention``; scatters and index adds ``table_update``; gathers and
``index_select`` ``select_gather``; radix and other sorts ``sort``; GEMM
kernels (cuBLAS, CUTLASS) and the matmul ops ``matmul``; copies, memcpy,
memset, ``cat`` and transposes ``data_formatting``; elementwise and
reduce kernels ``elementwise_fusion``.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

# rows at/above which an array is considered "a vocab-sized table"
BIG_ROWS = 5_000_000

# the trace categories of the device's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_ATTENTION = re.compile(r"mha|attention|softmax|flash", re.I)
_TABLE_UPDATE = re.compile(
    r"scatter|\bsweep|index_add|indexFunc|index_put|embedding_dense_backward", re.I)
_GATHER = re.compile(r"gather|take|index_select|indexSelect|aten::index\b|aten::embedding\b",
                     re.I)
_SORT = re.compile(r"sort|radix", re.I)
_MATMUL = re.compile(
    r"gemm|gemv|nvjet|xmma|cutlass|cublas|\baten::(mm|addmm|bmm|baddbmm|matmul|linear|dot|"
    r"einsum|_scaled_mm|conv\w*)\b", re.I)
# the port's hand-written kernels (``csrc/``), classed by their own name
# whatever op launched them: the attention kernels, the table sweeps, and
# the rest, which Pallas would have lowered to custom calls
_PORT = re.compile(r"\b(mha_\w+|sweep_\w+|block_tail_\w+|tail_(fwd|bwd)_mma|ffn_(fwd|bwd)_\w+|"
                   r"ffn_dump_kernel|attn_dump_kernel|fm_(fwd|bwd|dv)_\w*|reduce_partials)\b")
_FORMATTING = re.compile(
    r"memcpy|memset|copy|\baten::(cat|clone|contiguous|_to_copy|transpose)\b|CatArray|"
    r"transpose", re.I)
_ELEMENTWISE = re.compile(r"elementwise|reduce|multi_tensor_apply|distribution|at::native::|"
                          r"aten::", re.I)

Trace = Union[str, os.PathLike, Sequence[Dict]]


def find_trace_file(log_dir: str) -> Optional[str]:
    """Latest exported chrome trace (``*.json`` or ``*.json.gz``) under
    ``log_dir``."""
    hits = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*.json.gz"), recursive=True),
        key=os.path.getmtime,
    )
    return hits[-1] if hits else None


def load_device_events(trace_path: str) -> List[Dict]:
    """Complete events (ph == 'X') of the device's kernel, memcpy and
    memset tracks, each a copy with the launching ``cpu_op``'s name
    (``"op"``, "" if none) and input shapes (``"input_dims"``) added.

    Host events and the device's ``gpu_user_annotation`` spans are
    dropped, so a plain sum is device time with no overlap."""
    opener = gzip.open if str(trace_path).endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    ops: Dict[int, Tuple[str, list]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            args = e.get("args") or {}
            if "External id" in args:
                ops[args["External id"]] = (str(e.get("name", "")), args.get("Input Dims") or [])
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            op, dims = ops.get((e.get("args") or {}).get("External id"), ("", []))
            out.append(dict(e, op=op, input_dims=dims))
    return out


def _shapes(dims) -> List[List[int]]:
    """The tensor shapes in one ``Input Dims`` entry (a tensor's shape, a
    TensorList's list of shapes, or [] for a scalar)."""
    if dims and all(isinstance(d, list) for d in dims):
        return [s for d in dims for s in _shapes(d)]
    return [dims] if dims and all(isinstance(d, int) for d in dims) else []


def _shape_rows(op: str, input_dims) -> Tuple[int, int]:
    """(output_rows, max_operand_rows) from a ``cpu_op``'s name and input
    shapes.

    ``aten::index_add_`` on ``[[10000000, 128], [], [491520], [491520, 128]]``
    -> (10000000, 10000000); ``aten::index_select`` on
    ``[[10000000, 128], [], [3276800]]`` -> (0, 10000000)."""
    shapes = [_shapes(d) for d in input_dims or []]
    rows = [s[0] for group in shapes for s in group]
    if not rows:
        return 0, 0
    in_place = op.endswith("_") and not op.endswith("__")
    out_rows = max((s[0] for s in shapes[0]), default=0) if in_place else 0
    return out_rows, max(rows)


def classify_op(name: str, op: str = "", input_dims=None, category: str = "kernel",
                big_rows: int = BIG_ROWS) -> str:
    """The device-time class of a kernel (``name``) launched by ``op``
    with ``input_dims``; ``category`` is the trace event's category."""
    port = _PORT.search(name)
    if port:
        kernel = port.group(1)
        return ("attention" if kernel.startswith("mha_") else
                "table_update" if kernel.startswith("sweep_") else "custom_call")
    text = f"{name} {op}"
    if _ATTENTION.search(text):
        return "attention"
    out_rows, op_rows = _shape_rows(op, input_dims)
    if out_rows >= big_rows or _TABLE_UPDATE.search(text):
        return "table_update"
    if op_rows >= big_rows or _GATHER.search(text):
        return "select_gather"
    if _SORT.search(text):
        return "sort"
    if _MATMUL.search(text):
        return "matmul"
    if category in ("gpu_memcpy", "gpu_memset") or _FORMATTING.search(text):
        return "data_formatting"
    if _ELEMENTWISE.search(text):
        return "elementwise_fusion"
    return "other"


def _events(trace: Trace) -> Sequence[Dict]:
    return load_device_events(trace) if isinstance(trace, (str, os.PathLike)) else trace


def _class_of(e: Dict, big_rows: int) -> str:
    return classify_op(str(e.get("name", "")), e.get("op", ""), e.get("input_dims"),
                       str(e.get("cat", "")), big_rows)


def op_time_breakdown(trace: Trace, big_rows: int = BIG_ROWS) -> Dict[str, float]:
    """Total device ms per class over the whole trace window.  ``trace``
    is a trace file or the events ``load_device_events`` returned."""
    totals: Dict[str, float] = {}
    for e in _events(trace):
        g = _class_of(e, big_rows)
        totals[g] = totals.get(g, 0.0) + float(e.get("dur", 0.0)) / 1e3
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def top_ops(trace: Trace, n: int = 15) -> List[Tuple[str, float]]:
    """(kernel name, total device ms) for the n most expensive names."""
    by_name: Dict[str, float] = {}
    for e in _events(trace):
        name = str(e.get("name", ""))
        by_name[name] = by_name.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e3
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def top_ops_detailed(trace: Trace, n: int = 20, big_rows: int = BIG_ROWS) -> List[Dict]:
    """Top-n kernels by device ms with their class, launch count, the op
    that launched them and its input shapes."""
    by_name: Dict[str, Dict] = {}
    for e in _events(trace):
        name = str(e.get("name", ""))
        d = by_name.setdefault(
            name,
            {"name": name, "ms": 0.0, "calls": 0, "op": e.get("op", ""),
             "input_dims": str(e.get("input_dims") or "")[:400],
             "category": str(e.get("cat", "")), "class": _class_of(e, big_rows)},
        )
        d["ms"] += float(e.get("dur", 0.0)) / 1e3
        d["calls"] += 1
    return sorted(by_name.values(), key=lambda d: -d["ms"])[:n]
