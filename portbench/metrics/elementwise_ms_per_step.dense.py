"""Device milliseconds a DenseUNet train step spends outside its
convolutions, batch norms and optimizer: ReLU, the dropout draws and
masks, the concatenations, pools and upsampling, the running-statistics
updates, gradient adds, copies and sets."""

from portbench.dense_counts import is_norm_kernel


def read(rec):
    s = sum(v for n, c, v in rec["kernels"]
            if c not in ("conv", "optimizer") and not is_norm_kernel(n))
    return 1e3 * s / rec["units"]
