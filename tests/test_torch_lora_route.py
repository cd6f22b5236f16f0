"""Which kernel a card launch of ``ops.lora_matmul`` takes.

``ops.lora_route`` decides from dtype, shapes, strides and base addresses
alone, before any launch: bf16 operands that TMA can describe go to the
wgmma kernel (``csrc/lora_matmul_tc.cu``), everything else to the
mma.sync / float32 kernel (``csrc/lora_matmul.cu``, route ``"simt"``).
The distillation path's three projection shapes (M 4 x 1032, r 4), in
the forward layout and the backward's dx layout (transposed views of w,
b and a), must all take the wgmma kernel; float32, unaligned row strides,
unaligned bases and an empty reduction must not. Runs on the CPU: no
kernel is launched.
"""
import pytest
import torch

from repro_torch.kernels import ops

M = 4 * (1024 + 8)
BF16, F32 = torch.bfloat16, torch.float32

#: (dtype, K, N, layout, x_ptr, w_ptr, route). The layout is the
#: forward's x [M, K] and w [K, N], or dx's g [M, N] and w.T [N, K].
ROUTES = {
    # the distillation path's adapted projections
    "wq/attn.wo forward": (BF16, 1024, 1024, "forward", 0, 0, "wgmma"),
    "wq/attn.wo dx": (BF16, 1024, 1024, "dx", 0, 0, "wgmma"),
    "wk/wv forward": (BF16, 1024, 512, "forward", 0, 0, "wgmma"),
    "wk/wv dx": (BF16, 1024, 512, "dx", 0, 0, "wgmma"),
    "ffn.wo forward": (BF16, 4096, 1024, "forward", 0, 0, "wgmma"),
    "ffn.wo dx": (BF16, 4096, 1024, "dx", 0, 0, "wgmma"),
    # float32 never takes the wgmma kernel
    "float32": (F32, 4096, 1024, "forward", 0, 0, "simt"),
    # row strides that are no multiple of 8 elements; the card tests'
    # shapes (tests/test_torch_cuda.py LORA_CASES) among them
    "w row stride 132": (BF16, 96, 132, "forward", 0, 0, "simt"),
    "g row stride 132": (BF16, 96, 132, "dx", 0, 0, "simt"),
    "x row stride 36": (BF16, 36, 64, "forward", 0, 0, "simt"),
    "g row stride 36": (BF16, 64, 36, "dx", 0, 0, "simt"),
    "K 40 N 8 forward": (BF16, 40, 8, "forward", 0, 0, "wgmma"),
    "K 40 N 8 dx": (BF16, 40, 8, "dx", 0, 0, "wgmma"),
    "K 200 N 72 forward": (BF16, 200, 72, "forward", 0, 0, "wgmma"),
    "K 200 N 72 dx": (BF16, 200, 72, "dx", 0, 0, "wgmma"),
    # bases TMA cannot read from: x one element into its storage, w 8
    # bytes off
    "unaligned x": (BF16, 1024, 1024, "forward", 2, 0, "simt"),
    "unaligned w": (BF16, 1024, 1024, "forward", 0, 8, "simt"),
    "empty reduction": (BF16, 0, 64, "forward", 0, 0, "simt"),
}


def _operands(k, n, dtype, layout):
    """(x, w) of one call as lora_matmul sees them."""
    if layout == "forward":
        return (torch.empty((M, k), dtype=dtype),
                torch.empty((k, n), dtype=dtype))
    return (torch.empty((M, n), dtype=dtype),
            torch.empty((k, n), dtype=dtype).T)


@pytest.mark.parametrize("case", ROUTES)
def test_route_choice(case):
    dtype, k, n, layout, x_ptr, w_ptr, route = ROUTES[case]
    x, w = _operands(k, n, dtype, layout)
    assert ops.lora_route(x.dtype, x.shape, w.stride(), x_ptr,
                          w_ptr) == route


def test_cpu_calls_count_no_route():
    x, w = (t.normal_() for t in _operands(64, 64, BF16, "forward"))
    a = torch.randn((64, 4)).to(BF16)
    b = torch.randn((4, 64)).to(BF16)
    before = ops.route_counts()
    ops.lora_matmul(x[:128], w, a, b, scale=2.0)
    assert ops.route_counts() == before
    assert set(before["lora_matmul"]) == {"wgmma", "simt"}
