"""The flash backward's preprocess on its vec kernel
(``csrc/flash_bwd_preprocess_vec.cu``), emulated on the CPU.

delta = rowsum(dO * O) in float32. The kernel gives a row of D elements
to T = D * esz / 16 lanes, lane c holding the row's c-th 16-byte slice
(E = 16 / esz elements); each lane sums its slice's products with
float32 FMAs in element order from zero, then log2(T) xor shuffles add
the group's partials. This file repeats that arithmetic in numpy (an FMA
as one float64 product and add rounded to float32: the product of two
float32s is exact in float64, so this is within an ulp of the card's
fused rounding) on bf16 and float32 inputs at every head dim, with row
magnitudes spread over nine decades and ragged row counts, and holds it
row by row to the bound ``chip_smoke.py`` holds the card's delta to:
D * 2^-24 * sum_d |O dO| + 1e-30 of the float64 sum and of the port's
plain version, and 13 * 2^-24 * sum_d |O dO| of the float64 sum (a
product meets at most 12 roundings on its way; ``chip_smoke.py`` states
the derivation). It shows that the bound catches a kernel that drops one
16-byte slice of a row, where the old single bound, 1e-5 * max(1,
max|delta|), lets small rows through; that the kernel's tiles and grid
stride cover every row's every slice once; and the wrapper's route table
and input checks.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

U = 2.0 ** -24
ROW_ATOL = 1e-30
KERNEL_ROUNDINGS = 13       # 12 roundings, with room for second-order terms
KROWS = 4                   # rows a thread carries (the kernel's kRows)
DTYPES = {"bf16": (torch.bfloat16, 2), "f32": (torch.float32, 4)}
CASES = [(dt, d) for dt in DTYPES for d in (32, 64, 128)]
IDS = [f"{dt}-d{d}" for dt, d in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, rows, d, dtype):
    """o, dO [rows, d] as float32 arrays holding ``dtype`` values, each row
    scaled by 10^[-6, 3)."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-6, 3, (rows, 1))
    out = []
    for _ in range(2):
        x = (rng.standard_normal((rows, d)) * np.sqrt(scale)).astype(
            np.float32)
        out.append(torch.from_numpy(x).to(dtype).float().numpy())
    return out


def emulate(o, do, esz, drop=None):
    """The vec kernel's delta for float32 arrays o, dO [rows, D]; ``drop``:
    a [rows] array of slice indices left out of each row (a faulty
    kernel)."""
    rows, d = o.shape
    e = 16 // esz
    t = d // e
    a = o.astype(np.float64).reshape(rows, t, e)
    b = do.astype(np.float64).reshape(rows, t, e)
    acc = np.zeros((rows, t), np.float32)
    for i in range(e):
        acc = (a[:, :, i] * b[:, :, i] + acc).astype(np.float32)
    if drop is not None:
        acc[np.arange(rows), drop] = 0.0
    off = t // 2
    while off:
        acc = acc + acc[:, np.arange(t) ^ off]
        off //= 2
    return acc[:, 0]


def _exact(o, do):
    prod = o.astype(np.float64) * do.astype(np.float64)
    return prod.sum(-1), np.abs(prod).sum(-1)


@pytest.mark.parametrize("dtype,d", CASES, ids=IDS)
@pytest.mark.parametrize("rows", [999, 3])
def test_emulated_kernel_within_row_bound(dtype, d, rows):
    tdt, esz = DTYPES[dtype]
    o, do = _inputs(d + rows, rows, d, tdt)
    got = emulate(o, do, esz).astype(np.float64)
    exact, mag = _exact(o, do)
    assert np.all(np.abs(got - exact) <= KERNEL_ROUNDINGS * U * mag
                  + ROW_ATOL)
    assert np.all(np.abs(got - exact) <= d * U * mag + ROW_ATOL)
    plain = ops.flash_attention_bwd_preprocess(
        *[torch.from_numpy(x).to(tdt).view(1, 1, rows, d) for x in (o, do)])
    assert plain.dtype == torch.float32
    plain = plain.double().numpy().ravel()
    assert np.all(np.abs(got - plain) <= d * U * mag + ROW_ATOL)


@pytest.mark.parametrize("dtype,d", CASES, ids=IDS)
def test_row_bound_catches_a_dropped_slice(dtype, d):
    """Leaving one 16-byte slice out of each row moves every row past its
    bound; the old single bound passes the rows of small magnitude."""
    tdt, esz = DTYPES[dtype]
    rows = 200
    o, do = _inputs(7 * d, rows, d, tdt)
    t = d * esz // 16
    faulty = emulate(o, do, esz, drop=np.arange(rows) % t).astype(
        np.float64)
    exact, mag = _exact(o, do)
    err = np.abs(faulty - exact)
    assert np.all(err > d * U * mag + ROW_ATOL)
    old = 1e-5 * max(1.0, float(np.abs(exact).max()))
    assert np.any(err <= old)


def _covered(rows, d, esz, slots):
    """How many times the kernel's (CTA, warp, lane, j) walk loads each
    (row, slice): its index arithmetic in numpy."""
    t = d * esz // 16
    g = 32 // t
    warp_rows = g * KROWS
    cta_rows = 8 * warp_rows
    tiles = -(-rows // cta_rows)
    grid = min(tiles, slots)
    hits = np.zeros((rows, t), np.int64)
    thread = np.arange(8 * 32)
    lane = thread % 32
    c = lane % t
    lead = (thread // 32) * warp_rows + lane // t
    for block in range(grid):
        for tile in range(block, tiles, grid):
            for j in range(KROWS):
                row = tile * cta_rows + lead + j * g
                ok = row < rows
                np.add.at(hits, (row[ok], c[ok]), 1)
    return hits


@pytest.mark.parametrize("dtype,d", CASES, ids=IDS)
def test_tiles_and_grid_stride_cover_every_slice_once(dtype, d):
    """Ragged row counts, one row, and grids smaller than the tiles (the
    stride loop)."""
    esz = DTYPES[dtype][1]
    for rows, slots in ((999, 1056), (1, 1056), (5000, 3), (4096, 7)):
        assert np.all(_covered(rows, d, esz, slots) == 1), rows


def test_route_table_on_the_cpu():
    """The preprocess is routed: "vec" on the card ("simt" only through
    the private ``ops._preprocess_card``); on the CPU the plain version
    runs and counts no launch."""
    assert ops.ROUTED[ops.flash_attention_bwd_preprocess] == "vec"
    rng = np.random.default_rng(3)
    o, do = (torch.from_numpy(rng.standard_normal((2, 3, 37, 64))
                              .astype(np.float32)) for _ in range(2))
    want = ref.flash_attention_bwd_preprocess_ref(o, do)
    before = ops.route_counts()
    launches = ops.launch_counts()
    assert torch.equal(ops.flash_attention_bwd_preprocess(o, do), want)
    assert ops.route_counts() == before
    assert before["flash_attention_bwd_preprocess"].keys() == {"vec",
                                                               "simt"}
    assert ops.launch_counts() == launches


BAD_INPUTS = {
    "shapes differ": lambda: (torch.zeros((1, 2, 8, 64)),
                              torch.zeros((1, 2, 9, 64))),
    "dtypes differ": lambda: (torch.zeros((1, 2, 8, 64)),
                              torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)),
    "head_dim 48": lambda: (torch.zeros((1, 2, 8, 48)),) * 2,
    "strided": lambda: (torch.zeros((1, 2, 64, 8)).transpose(-1, -2),) * 2,
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_bad_inputs_are_rejected(case):
    """The wrapper checks its inputs on every device, before a launch."""
    o, do = BAD_INPUTS[case]()
    before = ops.launch_counts()
    with pytest.raises(ValueError):
        ops.flash_attention_bwd_preprocess(o, do)
    assert ops.launch_counts() == before
