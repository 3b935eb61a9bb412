"""K1's bf16 GEMM instances on the CPU: the rule that picks one (d and f
alone, one instance a pass whatever the call), its refusal past d = 1024,
the shared-memory layout of `csrc/sm90_gemm.cuh` against the card's
232,448 bytes, and a mirror of the C launches and tile schedule
(`gemm_launches`, `gemm_schedule` below), which covers every tile of every
launch exactly once and gives the two blocks of a pair-instance cluster
tiles that share their rows of A. The mirror is a copy of the C rule, not
the kernel: the card tests (tests/test_torch_port_gpu.py: the combined grid
bit for bit its split launches, rows independent of the grid, slabs) and
chip_smoke.py check the kernels themselves.
"""

import re
from pathlib import Path

import pytest

import glom_tpu_torch.kernels.grouped_mlp as k1

GEMM_SRC = Path(k1.__file__).resolve().parent.parent / "csrc" / "sm90_gemm.cuh"
SMEM_OPTIN = 232448  # a block's shared memory on sm_90 (the opt-in limit)
SMS, PAIR_CLUSTERS = 132, 66  # an H100's SMs, and the clusters of two it holds (PERF.md)


def gemm_launches(kind: str, G: int, M: int, d: int, f: int) -> list:
    """The GEMM launches one bf16 call makes, a mirror of the C entries'
    rule (csrc/grouped_mlp.cu, csrc/grouped_mlp_bwd.cu), in order:
    kind "fwd" (the forward: pass 1 and pass 2 over each row slab of
    `slab_rows` rows), "pre" (the pre-only entry: pass 1 over each slab) or
    "bwd" (the saved-pre backward: dh, dx, and the weight pass's dw1 and dw2
    problems in one grid). Each is a dict of the kernel, its instance
    (`gemm_instance`) and its problems, (K, N, groups, row0, row_end) each.
    The group rule (split, x_lo) picks slots, never tiles: it does not
    appear."""
    instance = k1.gemm_instance(d, f)
    if kind == "bwd":
        return [dict(kernel="mlp_bwd_dh_sm90", instance="wgmma", problems=[(d, f, G, 0, M)]),
                dict(kernel="mlp_bwd_dx_sm90", instance=instance, problems=[(f, d, G, 0, M)]),
                dict(kernel="mlp_bwd_dw_sm90", instance=instance,
                     problems=[(M, f, G, 0, d), (M, d, G, 0, f)])]
    if kind not in ("fwd", "pre"):
        raise ValueError(f"kind {kind!r}: fwd, pre or bwd")
    R = k1.slab_rows(G, M, f)
    launches = []
    for r0 in range(0, M, R):
        end = min(M, r0 + R)
        launches.append(dict(kernel="mlp_fwd_hidden_bf16", instance=instance,
                             problems=[(d, f, G, r0, end)]))
        if kind == "fwd":
            launches.append(dict(kernel="mlp_fwd_out_bf16", instance=instance,
                                 problems=[(f, d, G, r0, end)]))
    return launches


def gemm_tiles(problem) -> list:
    """A problem's tiles in the mainloop's order (csrc/sm90_gemm.cuh
    tile_pos): (group, first row, first column), columns fastest."""
    _, N, G, row0, row_end = problem
    m_tiles = -(-(row_end - row0) // k1.GEMM_ROW_TILE)
    n_tiles = -(-N // k1.GEMM_ROW_TILE)
    return [(g, row0 + k1.GEMM_ROW_TILE * r, k1.GEMM_ROW_TILE * c)
            for g in range(G) for r in range(m_tiles) for c in range(n_tiles)]


def gemm_schedule(launch: dict, units: int) -> dict:
    """The tiles each consumer ring of each block takes in one launch, in
    its order (a mirror of the mainloop's rule, csrc/sm90_gemm.cuh), as {(block, ring): [tile index, ...]}.
    "wgmma": min(tiles, units) blocks (units: the card's SMs), block b's
    ring r taking tiles b + (r + 2k) blocks. "wgmma_pair": min(pairs, units)
    clusters of two blocks (units: the clusters the card holds at once),
    cluster c's ring r taking pairs c + (r + 2k) clusters, and its rank q
    tile 2i + q of pair i."""
    tiles = sum(len(gemm_tiles(p)) for p in launch["problems"])
    pair = launch["instance"] == "wgmma_pair"
    if pair and tiles % 2:
        raise ValueError(f"the pair instance takes an even tile count, got {tiles}")
    items = tiles // 2 if pair else tiles
    grid = min(items, units)
    schedule = {}
    for unit in range(grid):
        for ring in range(2):
            for rank in range(2 if pair else 1):
                block = 2 * unit + rank if pair else unit
                schedule[(block, ring)] = [2 * i + rank if pair else i
                                           for i in range(unit + ring * grid, items, 2 * grid)]
    return schedule



# (d, f, instance): the pod width, the flagship, widths past and short of
# the rule (f not a multiple of 256; d below 1024, the flagship's and 768
# whole tile pairs but not measured).
WIDTHS = [(1024, 4096, "wgmma_pair"), (1024, 2048, "wgmma_pair"), (512, 2048, "wgmma"),
          (1024, 4160, "wgmma"), (960, 3840, "wgmma"), (64, 128, "wgmma"),
          (768, 3072, "wgmma")]
# (G, M): a plain launch, the combined grid (2L-1 groups), the loop's
# batch 8 at the pod width (two row slabs), an edge row count.
CALLS = [(12, 2048), (11, 2048), (23, 2048), (6, 160), (23, 160), (1, 32)]


@pytest.mark.parametrize("d,f,want", WIDTHS)
def test_instance_reads_d_and_f_alone(d, f, want):
    """Each pass runs one instance at a width, whatever the call: the
    width's (`gemm_instance`), and the single-block grid for dh."""
    assert k1.gemm_instance(d, f) == want
    seen = {}
    for kind in ("fwd", "pre", "bwd"):
        for G, M in CALLS:
            for launch in gemm_launches(kind, G, M, d, f):
                seen.setdefault(launch["kernel"], set()).add(launch["instance"])
    assert seen == {"mlp_fwd_hidden_bf16": {want}, "mlp_fwd_out_bf16": {want},
                    "mlp_bwd_dh_sm90": {"wgmma"}, "mlp_bwd_dx_sm90": {want},
                    "mlp_bwd_dw_sm90": {want}}


def test_instance_names_come_from_the_c_source():
    assert k1.K1_GEMM_INSTANCES == ("wgmma", "wgmma_pair")
    text = (GEMM_SRC.parent / "grouped_mlp.cu").read_text()
    assert 'INSTANCE_NAMES[] = {"wgmma", "wgmma_pair"}' in text


@pytest.mark.parametrize("d,f", [(1088, 4352), (2048, 8192), (1024 + 64, 4096)])
def test_instance_refuses_past_1024(d, f):
    with pytest.raises(ValueError, match="d <= 1024"):
        k1.gemm_instance(d, f)


@pytest.mark.parametrize("d,f", [(1000, 4096), (1024, 4000), (0, 4096)])
def test_instance_refuses_widths_the_kernels_do_not_take(d, f):
    with pytest.raises(ValueError):
        k1.gemm_instance(d, f)


def _constants():
    text = GEMM_SRC.read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_layout_fits_a_block():
    c = _constants()
    bm, bn, bk = c["BM"], c["BN"], c["BK"]
    stages, consumers = c["STAGES"], c["CONSUMERS"]
    ring = stages * (bm * bk * 2 + bn * bk * 2)
    stage_out = 16 * bn * 2
    smem = 1024 + consumers * ring + consumers * 4 * stage_out + consumers * 2 * stages * 8
    assert smem == 230496
    assert smem <= SMEM_OPTIN
    # The pair instance's warp stage holds a TMA store box of bf16 ([64
    # columns x PAIR_BOX_ROWS rows] twice) and a reduction box of f32 ([32
    # columns x PAIR_BOX_ROWS rows] twice) in the same bytes.
    assert 2 * 64 * c["PAIR_BOX_ROWS"] * 2 == stage_out
    assert 2 * 32 * c["PAIR_BOX_ROWS"] * 4 == stage_out
    assert c["PAIR_BLOCKS"] == 2


def _launch_cases():
    cases = []
    for d, f, _ in WIDTHS[:3]:
        for kind in ("fwd", "pre", "bwd"):
            for G, M in CALLS:
                for i, launch in enumerate(gemm_launches(kind, G, M, d, f)):
                    cases.append(pytest.param(launch, id=f"{kind}-d{d}-f{f}-G{G}-M{M}-{i}"))
    return cases


@pytest.mark.parametrize("launch", _launch_cases())
def test_schedule_covers_every_tile_once(launch):
    units = PAIR_CLUSTERS if launch["instance"] == "wgmma_pair" else SMS
    schedule = gemm_schedule(launch, units)
    tiles = sorted(t for ring in schedule.values() for t in ring)
    total = sum(len(gemm_tiles(p)) for p in launch["problems"])
    assert tiles == list(range(total))
    if launch["instance"] != "wgmma_pair":
        return
    # The two blocks of a cluster walk the same pairs: at each step their
    # tiles are one pair, the same group, problem and rows of A, adjacent
    # column blocks.
    positions = [(q, pos) for q, p in enumerate(launch["problems"]) for pos in gemm_tiles(p)]
    for (block, ring), mine in schedule.items():
        if block % 2:
            continue
        peer = schedule[(block + 1, ring)]
        assert len(peer) == len(mine)
        for a, b in zip(mine, peer):
            assert b == a + 1
            (qa, (ga, ra, ca)), (qb, (gb, rb, cb)) = positions[a], positions[b]
            assert (qa, ga, ra) == (qb, gb, rb) and cb == ca + k1.GEMM_ROW_TILE


def test_pod_loop_forward_runs_two_slabs_with_odd_row_tiles():
    """The combined grid at the pod width (23 groups, f = 4096) exceeds
    H_SCRATCH_CAP: 1,408 and 640 rows, 11 and 5 row tiles, every pair within
    a row block."""
    launches = gemm_launches("fwd", 23, 2048, 1024, 4096)
    assert [lc["problems"][0][3:] for lc in launches[::2]] == [(0, 1408), (1408, 2048)]
    assert [len(gemm_tiles(lc["problems"][0])) // 23 for lc in launches] == [
        11 * 32, 11 * 8, 5 * 32, 5 * 8]


def test_pair_schedule_refuses_an_odd_tile_count():
    launch = dict(kernel="mlp_fwd_out_bf16", instance="wgmma_pair",
                  problems=[(4096, 128, 1, 0, 128)])
    with pytest.raises(ValueError, match="even tile count"):
        gemm_schedule(launch, PAIR_CLUSTERS)


def test_check_kernel_args_still_refuses_past_1024():
    import torch

    from glom_tpu_torch.ops.ffw import GroupedFFWParams

    d, f = 1088, 4352
    params = GroupedFFWParams(torch.zeros(1, d, f), torch.zeros(1, f), torch.zeros(1, f, d),
                              torch.zeros(1, d))
    with pytest.raises(ValueError, match="d <= 1024"):
        k1.check_kernel_args(params, torch.zeros(1, 32, d), None)
