"""K1's backward on the CPU: the scratch each call hands between its
launches (`bwd_workspaces`: the bf16 saved-pre path's dpre, h and xa, the
recompute path's, the f32 one's), the arguments the card path refuses (a
16-byte aligned start for the cotangent and the saved pre in bf16, which
the saved-pre path reads by TMA; views of the loop's carry slots and of
dmean's prefixes pass), and that a CPU call runs the plain version and
counts no launch. The kernels themselves run only on the card
(tests/test_torch_port_gpu.py); their plain version is held against
glom_tpu in tests/test_torch_port_kernels_bwd.py.
"""

import math

import pytest
import torch

import glom_tpu_torch.kernels.grouped_mlp as k1
from glom_tpu_torch.ops.ffw import GroupedFFWParams

BF16, F32 = torch.bfloat16, torch.float32
L, M, D, F, N = 3, 64, 64, 128, 32
COUNTS = ("LAUNCHES_BWD", "LAUNCHES_BWD_ADD", "LAUNCHES_BWD_ACC", "LAUNCHES_BWD_ACC_ADD",
          "LAUNCHES_BWD_ACC_CAT")


def _params(G, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return GroupedFFWParams(*(
        (torch.randn(*shape, generator=g) * scale).to(dtype)
        for shape, scale in (((G, D, F), D ** -0.5), ((G, F), 0.1), ((G, F, D), F ** -0.5),
                             ((G, D), 0.1))))


def _randn(*shape, dtype=F32, seed=1):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


def _misaligned(shape, dtype):
    """A contiguous view one element past a 64-byte aligned start."""
    flat = torch.zeros(math.prod(shape) + 16, dtype=dtype)
    view = flat[1:1 + math.prod(shape)].view(shape)
    assert view.data_ptr() % 16
    return view


# (form, G, split): a plain launch without and with the addend, and the
# combined grid (2L-1 groups, L-1 of them taking the addend).
FORMS = [("plain", L, 0), ("addend", L, L), ("cat", 2 * L - 1, L - 1)]


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("saved_pre", [True, False])
@pytest.mark.parametrize("form,G,split", FORMS)
def test_workspaces(dtype, saved_pre, form, G, split):
    x = torch.zeros(L + 1 if form == "cat" else G, M, D, dtype=dtype)
    ws = k1.bwd_workspaces(x, G, F, split, saved_pre)
    hidden = ((G, M, F), dtype)
    want = {"dpre_ws": hidden}
    if dtype == BF16 or not saved_pre:  # f32 forms h from the saved pre itself
        want["h_ws"] = hidden
    if split:
        want["dx32_ws"] = ((split, M, D), F32)
        if dtype == BF16 and saved_pre:  # the weight pass's xa = x + tile(add)
            want["xa"] = ((split, M, D), dtype)
    assert {k: (tuple(t.shape), t.dtype) for k, t in ws.items()} == want
    assert all(t.device == x.device and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in ws.values())
    ptrs = [t.data_ptr() for t in ws.values()]
    assert len(set(ptrs)) == len(ptrs) and x.data_ptr() not in ptrs


def _args(dtype, bad=None):
    params = _params(L, dtype)
    x = torch.zeros(L, M, D, dtype=dtype)
    shapes = {"g": (L, M, D), "pre": (L, M, F)}
    views = {name: (_misaligned(shape, dtype) if name == bad else torch.zeros(shape, dtype=dtype))
             for name, shape in shapes.items()}
    return params, x, views


@pytest.mark.parametrize("name", ["g", "pre"])
def test_bf16_refuses_misaligned_views(name):
    params, x, v = _args(BF16, bad=name)
    with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
        k1.check_bwd_args(params, x, v["g"], pre=v["pre"])


@pytest.mark.parametrize("name", ["g", "pre"])
def test_f32_takes_misaligned_views(name):
    """f32 reads the cotangent and pre element by element: a view one
    element in is fine."""
    params, x, v = _args(F32, bad=name)
    k1.check_bwd_args(params, x, v["g"], pre=v["pre"])


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_loop_carry_slot_and_dmean_prefix_views_pass(dtype):
    """The loop's K1 backward reads x as slots of the [L+1] carry and g as
    dmean or a prefix of its levels: each view starts a whole [M, d] slot
    in (d % 64 == 0), so it stays aligned, over the combined grid and its
    split pair alike."""
    carry = torch.zeros(L + 1, M, D, dtype=dtype)
    dmean = torch.zeros(L, M, D, dtype=dtype)
    add = torch.zeros(N, D, dtype=dtype)
    td, bu = _params(L - 1, dtype), _params(L, dtype, seed=2)
    wcat = k1.cat_params(td, bu)
    for t in (carry[2:], carry[:L], dmean[:L - 1]):
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
    G = 2 * L - 1
    acc = GroupedFFWParams(*(torch.zeros(t.shape) for t in wcat))
    k1.check_bwd_args(wcat, carry, dmean, add=add, pre=torch.zeros(G, M, F, dtype=dtype),
                      acc=acc, da_in=torch.zeros(N, D), cat=True)
    k1.check_bwd_args(td, carry[2:], dmean[:L - 1], add=add,
                      pre=torch.zeros(L - 1, M, F, dtype=dtype))
    k1.check_bwd_args(bu, carry[:L], dmean, pre=torch.zeros(L, M, F, dtype=dtype))


def test_refuses_wrong_cotangent_shape():
    params, x, v = _args(BF16)
    with pytest.raises(ValueError, match="g must be"):
        k1.check_bwd_args(params, x, v["g"][:, :32])


def _counts():
    return tuple(getattr(k1, name) for name in COUNTS)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("saved_pre", [True, False])
@pytest.mark.parametrize("with_add", [False, True])
def test_cpu_backward_runs_the_plain_version(dtype, saved_pre, with_add):
    """On CPU tensors the wrapper returns the plain version's results and
    launches nothing, per-op and in accumulate mode."""
    params = _params(L, dtype)
    x, g = _randn(L, M, D, dtype=dtype), _randn(L, M, D, dtype=dtype, seed=2)
    add = _randn(N, D, dtype=dtype, seed=3) if with_add else None
    pre = k1.grouped_mlp_pre_plain(params, x, add) if saved_pre else None
    before = _counts()
    got = k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre)
    want = k1.grouped_mlp_bwd_plain(params, x, g, add, pre)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert (got[2] is None) == (want[2] is None)
    if with_add:
        assert torch.equal(got[2], want[2])
    acc = GroupedFFWParams(*(_randn(*t.shape, seed=4) for t in params))
    da_in = _randn(N, D, seed=5) if with_add else None
    want_acc = GroupedFFWParams(*(t.clone() for t in acc))
    want_da = None if da_in is None else da_in.clone()
    k1.grouped_mlp_bwd(params, x, g, add=add, pre=pre, acc=acc, da_in=da_in)
    k1.grouped_mlp_bwd_plain(params, x, g, add, pre, want_acc, want_da)
    assert all(torch.equal(a, b) for a, b in zip(acc, want_acc))
    if with_add:
        assert torch.equal(da_in, want_da)
    assert _counts() == before


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cpu_cat_backward_runs_the_plain_version(dtype):
    """The combined grid on the CPU: the plain version's two split calls,
    no launch counted."""
    td, bu = _params(L - 1, dtype), _params(L, dtype, seed=2)
    wcat = k1.cat_params(td, bu)
    carry, dmean = _randn(L + 1, M, D, dtype=dtype), _randn(L, M, D, dtype=dtype, seed=2)
    add = _randn(N, D, dtype=dtype, seed=3)
    pre = k1.grouped_mlp_pre_plain(wcat, carry, add, cat=True)
    acc = GroupedFFWParams(*(_randn(*t.shape, seed=4) for t in wcat))
    da_in = _randn(N, D, seed=5)
    want_acc = GroupedFFWParams(*(t.clone() for t in acc))
    want_da = da_in.clone()
    before = _counts()
    dx, grads, da = k1.grouped_mlp_bwd(wcat, carry, dmean, add=add, pre=pre, acc=acc,
                                       da_in=da_in, cat=True)
    want = k1.grouped_mlp_bwd_plain(wcat, carry, dmean, add, pre, want_acc, want_da, cat=True)
    assert _counts() == before
    assert torch.equal(dx, want[0]) and torch.equal(da, want_da)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_acc))
