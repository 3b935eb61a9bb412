"""K2's backward instances on the CPU: the rule that picks the bf16 "wgmma"
kernels or the f32 "fma" ones (`k2_bwd_instance`), the arguments the card
path refuses (16-byte alignment of every tensor the bf16 kernels read by TMA
or in 16-byte vectors, views of the loop's carry slots included), and the
scratches each call hands between its launches (`bwd_workspaces`). The
kernels themselves run only on the card (tests/test_torch_port_gpu.py);
their plain versions are held against glom_tpu in
tests/test_torch_port_kernels_bwd.py and test_torch_port_onesweep.py.
"""

import math

import pytest
import torch

import glom_tpu_torch.kernels.consensus_update as k2

BF16, F32 = torch.bfloat16, torch.float32
L, B, N, D = 3, 2, 64, 128


@pytest.mark.parametrize("dtype,n,d,want", [
    (F32, 64, 128, "fma"),
    (F32, 48, 64, "fma"),
    (F32, 4096, 512, "fma"),
    (F32, 96, 704, "fma"),
    (BF16, 32, 64, "wgmma"),
    (BF16, 96, 128, "wgmma"),  # n = 32 x 3: the last 64-row block half past n
    (BF16, 256, 512, "wgmma"),  # the flagship
    (BF16, 4096, 512, "wgmma"),  # the long row
    (BF16, 96, 576, "wgmma"),  # 16-row tiles past d = 512
    (BF16, 96, 640, "wgmma"),
    (BF16, 96, 704, "wgmma_wide"),  # past the resident tiles: d streamed
    (BF16, 256, 1024, "wgmma_wide"),  # the imagenet224-pod width
    (F32, 256, 1024, "fma"),
])
def test_instance_rule(dtype, n, d, want):
    assert k2.k2_bwd_instance(dtype, n, d) == want
    assert k2.K2_BWD_INSTANCES[k2.K2_BWD_INSTANCES.index(want)] == want


@pytest.mark.parametrize("dtype,n,d", [
    (BF16, 48, 128),  # n not a multiple of 32
    (BF16, 64, 96),  # d not a multiple of 64
    (BF16, 64, 1088),  # past the widest row any K2 kernel takes (d <= 1024)
    (F32, 64, 1088),
    (torch.float16, 64, 128),
])
def test_instance_rule_refuses(dtype, n, d):
    with pytest.raises(ValueError):
        k2.k2_bwd_instance(dtype, n, d)


def _aligned(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


def _misaligned(shape, dtype):
    """A contiguous view one element past a 64-byte aligned start."""
    flat = torch.zeros(math.prod(shape) + 16, dtype=dtype)
    view = flat[1:1 + math.prod(shape)].view(shape)
    assert view.data_ptr() % 16
    return view


def _args(dtype, bad=None):
    full, rows = (L, B, N, D), (L, B, N, 1)
    shapes = {"levels": (full, dtype), "g": (full, dtype), "m": (rows, F32), "l": (rows, F32),
              "dx_bu": (full, dtype), "dx_td": ((L - 1, B, N, D), dtype),
              "dcons": (full, dtype), "cons": (full, dtype), "dq": (full, F32), "dd": (rows, F32)}
    return {name: (_misaligned if name == bad else _aligned)(*spec)
            for name, spec in shapes.items()}


def _check(a, combine=True, cons=False):
    k2._check_bwd_args(a["levels"], a["g"], a["m"], a["l"], 8, 0.0,
                       a["dx_bu"] if combine else None, a["dx_td"] if combine else None,
                       combine, dcons=a["dcons"], cons=a["cons"] if cons else None,
                       dq=a["dq"], dd=a["dd"])


NAMES = ["levels", "g", "m", "l", "dx_bu", "dx_td", "dcons", "cons", "dq", "dd"]


@pytest.mark.parametrize("name", NAMES)
def test_bf16_refuses_misaligned_views(name):
    a = _args(BF16, bad=name)
    with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
        _check(a, cons=name == "cons")


@pytest.mark.parametrize("name", NAMES)
def test_f32_takes_misaligned_views(name):
    """"fma" reads element by element: an f32 view one element in is fine."""
    _check(_args(F32, bad=name), cons=name == "cons")


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_loop_carry_slot_views_pass(dtype):
    """The combine reads levels as slots 1..L of the loop's [L+1] carry and
    the streams as slot views of the K1 backward's [2L-1] dx: each view
    starts a whole slot (B n d elements, d % 64 == 0) in, so it stays
    aligned."""
    ext = torch.zeros(L + 1, B, N, D, dtype=dtype)
    dx = torch.zeros(2 * L - 1, B * N, D, dtype=dtype)
    dx_bu, dx_td = dx[L - 1:].view(L, B, N, D), dx[: L - 1].view(L - 1, B, N, D)
    m = torch.zeros(L, B, N, 1)
    for t in (ext[1:], dx_bu, dx_td):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    k2._check_bwd_args(ext[1:], ext[1:].clone(), m, m.clone(), 8, 0.0, dx_bu, dx_td, True)


def test_refuses_wide_bf16_rows():
    lv = torch.zeros(2, 1, 64, 1088, dtype=BF16)
    m = torch.zeros(2, 1, 64, 1)
    with pytest.raises(ValueError, match="d <= 1024"):
        k2._check_bwd_args(lv, lv, m, m, 8, 0.0)


@pytest.mark.parametrize("dtype,form,want", [
    (BF16, "dq", {"khat": ((L, B, N, D), BF16)}),
    (BF16, "dkv", {"khat": ((L, B, N, D), BF16), "dv": ((L, B, N, D), F32)}),
    (BF16, "onesweep", {"dq": ((L, B, N, D), F32), "dd": ((L, B, N, 1), F32),
                        "dcons": ((L, B, N, D), BF16), "khat": ((L, B, N, D), BF16),
                        "dv": ((L, B, N, D), F32)}),
    (F32, "dq", {}),
    (F32, "dkv", {}),
    (F32, "onesweep", {"dq": ((L, B, N, D), F32), "dd": ((L, B, N, 1), F32),
                       "dcons": ((L, B, N, D), F32)}),
])
def test_workspaces(dtype, form, want):
    lv = torch.zeros(L, B, N, D, dtype=dtype)
    ws = k2.bwd_workspaces(lv, form)
    assert {k: (tuple(t.shape), t.dtype) for k, t in ws.items()} == want
    assert all(t.device == lv.device and t.is_contiguous() for t in ws.values())
    ptrs = [t.data_ptr() for t in ws.values()]
    assert len(set(ptrs)) == len(ptrs) and lv.data_ptr() not in ptrs


@pytest.mark.parametrize("form,want", [
    ("dq", {"khat": BF16}),
    ("dkv", {"khat": BF16, "dv": F32}),
    ("onesweep", {"dq": F32, "dd": F32, "dcons": BF16, "khat": BF16, "dv": F32}),
])
def test_workspaces_wide(form, want):
    """"wgmma_wide" (the imagenet224-pod width, d = 1024) takes the same
    scratches as "wgmma": its dk pass applies the norm VJP itself, so no
    f32 dk is handed to a finishing launch."""
    lv = torch.zeros(2, 1, 256, 1024, dtype=BF16)
    ws = k2.bwd_workspaces(lv, form)
    assert {k: t.dtype for k, t in ws.items()} == want
    for k, t in ws.items():
        assert tuple(t.shape) == ((2, 1, 256, 1) if k == "dd" else tuple(lv.shape))


@pytest.mark.parametrize("d", [704, 768, 1024])
@pytest.mark.parametrize("form", ["dq", "dkv", "onesweep"])
def test_workspaces_wide_widths_match_narrow(d, form):
    """Every width of "wgmma_wide" allocates what "wgmma" allocates for the
    same form, at its own shape: no dk scratch at any width."""
    wide = k2.bwd_workspaces(torch.zeros(2, 1, 96, d, dtype=BF16), form)
    narrow = k2.bwd_workspaces(torch.zeros(2, 1, 96, 640, dtype=BF16), form)
    assert k2.k2_bwd_instance(BF16, 96, d) == "wgmma_wide"
    assert {k: t.dtype for k, t in wide.items()} == {k: t.dtype for k, t in narrow.items()}
    assert "dk" not in wide
    for k, t in wide.items():
        assert tuple(t.shape) == ((2, 1, 96, 1) if k == "dd" else (2, 1, 96, d))


@pytest.mark.parametrize("L,B,n,d,rows,upper", [
    (12, 2, 256, 1024, 4, 1024),  # the pod's per-iteration pair: 96 clusters
    (12, 8, 256, 1024, 4, 1024),  # the pod loop's combine: 384 clusters
    (3, 2, 96, 704, 2, 704),  # an odd width: rank 1 holds three 64-column boxes
    (3, 1, 64, 768, 1, 768),  # rank 1 holds four boxes
])
def test_wide_bwd_grid(L, B, n, d, rows, upper):
    """The wide backward's clusters: two blocks for each 64 rows of a slot,
    the pair along y; rank 0 holds columns 0-511, rank 1 the rest of d."""
    geo = k2.wide_bwd_grid(L, B, n, d)
    assert geo["grid"] == (rows, 2, L * B)
    assert geo["cluster"] == (1, 2, 1)
    assert geo["clusters"] == rows * L * B
    assert geo["columns"] == [(0, 512), (512, upper)]
    lo, hi = geo["columns"][1]
    assert (hi - lo) % 64 == 0 and 0 < hi - lo <= 512


@pytest.mark.parametrize("d", [640, 1088, 960 + 32])
def test_wide_bwd_grid_refuses_other_widths(d):
    with pytest.raises(ValueError, match="wide backward"):
        k2.wide_bwd_grid(2, 1, 64, d)


def test_workspaces_refuse_unknown_form():
    with pytest.raises(ValueError, match="form"):
        k2.bwd_workspaces(torch.zeros(L, B, N, D, dtype=BF16), "dk")


def test_cpu_backward_runs_the_plain_version():
    """On CPU tensors the wrappers take the plain version and launch
    nothing, in both dtypes and every form."""
    g = torch.Generator().manual_seed(0)
    before = (k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_COMBINE_DQ,
              k2.LAUNCHES_BWD_ONESWEEP)
    for dtype in (BF16, F32):
        lv = torch.randn(L, B, N, D, generator=g).to(dtype)
        go = torch.randn(L, B, N, D, generator=g).to(dtype)
        streams = dict(dx_bu=torch.randn(L, B, N, D, generator=g).to(dtype),
                       dx_td=torch.randn(L - 1, B, N, D, generator=g).to(dtype))
        _, m, l, cons = k2.fused_consensus_update(lv, lv, lv[1:], side=8, cons=True)
        got = k2.consensus_update_bwd(lv, go, m, l, side=8, combine=True, **streams)
        want = k2.consensus_update_bwd_plain(lv, go, m, l, side=8, **streams)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        one = k2.consensus_bwd_onesweep(lv, go, m, l, cons, side=8)
        assert torch.equal(one, k2.consensus_bwd_onesweep_plain(lv, go, m, l, cons, side=8))
    assert (k2.LAUNCHES_BWD_DQ, k2.LAUNCHES_BWD_DKV, k2.LAUNCHES_BWD_COMBINE_DQ,
            k2.LAUNCHES_BWD_ONESWEEP) == before
