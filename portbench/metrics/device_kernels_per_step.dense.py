"""Device kernels per DenseUNet train step, counted by the driver from the
profiler's device events of the traced window (drivers/train_dense.py)."""


def read(rec):
    n = rec.get("device_kernels")
    return None if n is None else n / rec["units"]
