"""Card probes of the port, each runnable with ``python -m``: the scatter
probe (``scatter_probe``: how fast the card reads, modifies and writes
the embedding table) and the dropout-mask device check
(``hw_dropout_device_check``: the masks the dropping encoder kernels draw,
dumped and rebuilt into their outputs and gradients).  Both need a CUDA
card."""
