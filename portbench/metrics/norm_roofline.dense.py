"""The batch norms' share of their roofline in a DenseUNet train step: the
least time of the batch-norm + ReLU planes at the HBM rate (forward x read
and y written, backward g and x read and dx written: portbench/
dense_counts.py) over the device time of the batch-norm kernels; nothing
where none ran."""

from portbench.dense_counts import norm_seconds


def read(rec):
    t = norm_seconds(rec)
    if t <= 0:
        return None
    return 100.0 * rec["norm_min_s_per_unit"] * rec["units"] / t
