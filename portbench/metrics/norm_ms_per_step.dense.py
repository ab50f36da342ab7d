"""Device milliseconds a DenseUNet train step spends in its batch norms,
forward and backward: the kernels whose name holds ``batch_norm``
(PyTorch's native batch norm) or ``bnrelu``.  A later hand-written batch
norm (+ ReLU) must carry ``batch_norm`` or ``bnrelu`` in its kernel's name
to be counted here (portbench/dense_counts.NORM_TOKENS)."""

from portbench.dense_counts import norm_seconds


def read(rec):
    return 1e3 * norm_seconds(rec) / rec["units"]
