"""The trace reduction: device intervals merged (overlapping kernels count
once), host spans' device-side annotations dropped, the window bounded by
the benchmark's span, idle gaps named by the span and the deepest host
operation at their middle, launches counted; the kernel classes."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import trace


class FakeProf:
    def __init__(self, events):
        self._events = [SimpleNamespace(
            name=n, device_type=d,
            time_range=SimpleNamespace(start=s, end=e))
            for n, d, s, e in events]

    def events(self):
        return self._events


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_reduce_merges_and_names_gaps():
    prof = FakeProf([
        ("portbench.window", CPU, 0, 1000),
        ("portbench.dispatch", CPU, 0, 600),
        ("cudaGraphLaunch", CPU, 10, 20),
        ("cudaLaunchKernel", CPU, 700, 710),
        ("portbench.input", CPU, 600, 900),
        ("portbench.window", GPU, 0, 1000),      # a span's annotation
        ("sm90_xmma_fprop_conv", GPU, 100, 300),
        ("in_relu_fwd_kernel", GPU, 200, 400),   # overlaps the conv
        ("multi_tensor_apply_kernel", GPU, 500, 550),
        ("late_kernel", GPU, 950, 1100),         # cut at the window's end
    ])
    rec = trace.reduce(prof)
    assert rec["window_s"] == pytest.approx(1000e-6)
    assert rec["busy_s"] == pytest.approx((300 + 50 + 50) * 1e-6)
    assert rec["host_launches"] == 2
    assert trace.class_seconds(rec, "b2") == pytest.approx(200e-6)
    assert trace.class_seconds(rec, "conv") == pytest.approx(200e-6)
    assert trace.class_seconds(rec, "optimizer") == pytest.approx(50e-6)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"dispatch / portbench.dispatch": 200e-6,
                                  "input / portbench.input": 400e-6})
    assert rec["breakdown"]["device_ops"][0][0] in (
        "sm90_xmma_fprop_conv", "in_relu_fwd_kernel")


def test_reduce_refuses_a_trace_without_device_work():
    prof = FakeProf([("portbench.window", CPU, 0, 10),
                     ("portbench.window", GPU, 0, 10)])
    with pytest.raises(RuntimeError):
        trace.reduce(prof)


@pytest.mark.parametrize("name,cls", [
    ("void in_relu_bwd_kernel<bf16>", "b2"),
    ("guide_render_kernel", "b1"),
    ("geodesic2d_raster", "g1"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel", "conv"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm", "conv"),
    ("void at::native::multi_tensor_apply_kernel", "optimizer"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<4, add>", "elementwise"),
])
def test_kernel_class(name, cls):
    assert trace.kernel_class(name) == cls
