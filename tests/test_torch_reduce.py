"""The port's grid min/max reduction against the JAX package's Pallas kernel.

``repro_torch.kernels.reduce.grid_minmax_ref`` (what ``grid_minmax`` runs
on a CPU tensor) is held to ``repro.kernels.reduce.grid_minmax_pallas`` in
interpret mode and to numpy, exactly (tolerance 0: int64 in, int64 out),
on grids past 2**31, on tie grids and on degenerate shapes.  The CUDA
kernel's launch planner (``launch_plan``) and a numpy model of its walk
are checked here; the kernel itself is held to ``grid_minmax_ref`` on the
card by ``chip_smoke.py`` and ``scripts/kernel_probe.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _jax_reference import jax_grid  # noqa: E402,F401

from repro_torch.kernels import reduce as treduce  # noqa: E402


def _random_case(seed, n_conv, n_simd, n_rows, nb, lo=2 ** 31, hi=2 ** 34):
    rng = np.random.default_rng(seed)
    conv = rng.integers(lo, hi, size=(n_conv, nb), dtype=np.int64)
    simd = rng.integers(lo, hi, size=(n_simd, nb), dtype=np.int64)
    s3_of = rng.integers(0, n_conv, size=n_rows, dtype=np.int64)
    v_of = rng.integers(0, n_simd, size=n_rows, dtype=np.int64)
    return conv, simd, s3_of, v_of


def _tie_case(seed, n_rows, nb):
    """Few distinct values, so the minimum and the maximum each occur in
    several rows and at several column positions."""
    return _random_case(seed, 5, 3, n_rows, nb, lo=2 ** 33, hi=2 ** 33 + 3)


CASES = {
    "random_past_2_31": _random_case(0, 7, 4, 37, 23),
    "ties": _tie_case(1, 31, 17),
    "ties_wide": _tie_case(2, 3, 70),
    "1x1": _random_case(3, 1, 1, 1, 1),
    "1xN": _random_case(4, 1, 2, 1, 53),
    "Nx1": _random_case(5, 6, 3, 41, 1),
    "all_equal": (np.full((2, 9), 2 ** 32, np.int64),
                  np.zeros((1, 9), np.int64),
                  np.array([1, 0, 1, 1], np.int64), np.zeros(4, np.int64)),
}


def _numpy_minmax(conv, simd, s3_of, v_of):
    flat = (conv[s3_of] + simd[v_of]).ravel()
    bi, wi = flat.argmin(), flat.argmax()
    return np.array([flat[bi], bi, flat[wi], wi], dtype=np.int64)


def _tensors(case):
    return tuple(torch.from_numpy(a) for a in case)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_numpy_and_pallas(jax_grid, name):
    import jax.numpy as jnp
    _, jreduce = jax_grid
    case = CASES[name]
    want = _numpy_minmax(*case)
    got = treduce.grid_minmax_ref(*_tensors(case)).numpy()
    conv, simd, s3_of, v_of = case
    with jreduce.enable_x64():           # int64 operands, as gridax builds them
        pallas = np.asarray(jreduce.grid_minmax_pallas(
            jnp.asarray(conv), jnp.asarray(simd),
            jnp.asarray(s3_of, dtype=jnp.int32),
            jnp.asarray(v_of, dtype=jnp.int32), interpret=True))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pallas, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_on_cpu_is_ref_and_launches_nothing(name):
    before = treduce.grid_minmax.launches
    t = _tensors(CASES[name])
    np.testing.assert_array_equal(treduce.grid_minmax(*t).numpy(),
                                  treduce.grid_minmax_ref(*t).numpy())
    assert treduce.grid_minmax.launches == before


def test_ties_resolve_to_first_occurrence():
    conv, simd, s3_of, v_of = CASES["ties"]
    flat = (conv[s3_of] + simd[v_of]).ravel()
    assert (flat == flat.min()).sum() > 1 and (flat == flat.max()).sum() > 1
    out = treduce.grid_minmax_ref(*_tensors(CASES["ties"])).numpy()
    assert out[1] == np.flatnonzero(flat == flat.min())[0]
    assert out[3] == np.flatnonzero(flat == flat.max())[0]


def test_values_past_int32_stay_exact():
    out = treduce.grid_minmax_ref(*_tensors(CASES["random_past_2_31"]))
    assert out.dtype == torch.int64 and int(out[0]) > 2 ** 32


def _valid():
    return _tensors(CASES["random_past_2_31"])


@pytest.mark.parametrize("fn", [treduce.grid_minmax, treduce.grid_minmax_ref])
def test_input_checks(fn):
    conv, simd, s3_of, v_of = _valid()
    with pytest.raises(TypeError):
        fn(conv.to(torch.int32), simd, s3_of, v_of)
    with pytest.raises(TypeError):
        fn(conv, simd, s3_of.to(torch.int32), v_of)
    with pytest.raises(ValueError, match="contiguous"):
        fn(conv.t().contiguous().t(), simd, s3_of, v_of)
    with pytest.raises(ValueError, match="empty grid"):
        fn(conv, simd, s3_of[:0], v_of[:0])
    with pytest.raises(ValueError, match="empty grid"):
        fn(conv[:, :0].contiguous(), simd[:, :0].contiguous(), s3_of, v_of)
    with pytest.raises(ValueError, match="width"):
        fn(conv, simd[:, 1:].contiguous(), s3_of, v_of)
    with pytest.raises(ValueError, match="length"):
        fn(conv, simd, s3_of, v_of[1:])


def test_other_devices_raise_and_never_reach_ref(monkeypatch):
    def forbidden(*a):
        raise AssertionError("plain version reached for a non-CPU tensor")
    monkeypatch.setattr(treduce, "grid_minmax_ref", forbidden)
    meta = [t.to("meta") for t in _valid()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        treduce.grid_minmax(*meta)


# ---- the launch planner (kernels/reduce.py::launch_plan) ----------------

def _items(plan, n_rows, nb):
    """``(r0, r1, c0, c1)`` of every work item, as the kernel derives them
    from the item's number."""
    out = []
    for k in range(plan.n_items):
        r0 = (k // plan.col_tiles) * plan.rows_per_item
        c0 = (k % plan.col_tiles) * treduce.TILE_COLS
        out.append((r0, min(r0 + plan.rows_per_item, n_rows),
                    c0, min(c0 + treduce.TILE_COLS, nb)))
    return out


def _warp_rows(ws, we):
    """Each warp's ``[ra, rb)`` of a window's rows ``[ws, we)``, as the
    kernel splits them."""
    per = -(-(we - ws) // treduce.WARPS)
    out = []
    for w in range(treduce.WARPS):
        ra = min(ws + w * per, we)
        out.append((ra, min(ra + per, we)))
    return out


def _windows(s3_item, slots):
    """``(q0, ws, we)`` of each half window of an item's runs, as the
    kernel cuts them: windows of ``slots`` runs, each in two halves (the
    first the larger), half ``k`` covering runs from ``q0`` and rows
    ``[ws, we)``."""
    starts = np.flatnonzero(np.r_[True, np.diff(s3_item) != 0])
    n, nrow = len(starts), len(s3_item)
    out = []
    for q0 in range(0, n, slots):
        q2 = min(q0 + slots, n)
        q1 = q0 + (q2 - q0 + 1) // 2
        for qa, qb in ((q0, q1), (q1, q2)):
            out.append((qa, starts[qa] if qa < n else nrow,
                        starts[qb] if qb < n else nrow))
    return out


def _partition(intervals, n):
    """The intervals are non-empty and tile ``[0, n)`` exactly once."""
    ivs = sorted(set(intervals))
    return (all(a < b for a, b in ivs) and ivs[0][0] == 0
            and ivs[-1][1] == n
            and all(x[1] == y[0] for x, y in zip(ivs, ivs[1:])))


@pytest.mark.parametrize("n_rows", [1, 2, 131, 132, 528, 529, 2345, 96721])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_launch_plan_covers_every_candidate_once(n_rows, n_sm):
    for nb in (1, 63, 64, 65, 311, 2345, 100_003):
        plan = treduce.launch_plan(n_rows, nb, 15, n_sm)
        items = _items(plan, n_rows, nb)
        # every (row chunk, column tile) pair is one item, and the chunks
        # and tiles each partition their axis: every candidate once
        assert len(set(items)) == len(items) == plan.n_items
        rows = {(r0, r1) for r0, r1, _, _ in items}
        cols = {(c0, c1) for _, _, c0, c1 in items}
        assert len(rows) == plan.row_chunks and len(cols) == plan.col_tiles
        assert _partition(rows, n_rows) and _partition(cols, nb)
        # block b walks items b, b + blocks, ...: every item once
        assert 1 <= plan.blocks <= min(plan.n_items,
                                       treduce.BLOCKS_PER_SM * n_sm)
        assert 1 <= plan.rows_per_item <= treduce.MAX_ITEM_ROWS
        # the windows of runs split each item's rows (here every row a run
        # of its own, the most windows), the warps each window's rows, the
        # lanes the item's columns (two each, the last lane of a ragged
        # tile one)
        for r0, r1, c0, c1 in {items[0], items[-1]}:
            wins = [w for w in _windows(np.arange(r1 - r0), plan.run_slots)
                    if w[1] < w[2]]
            assert _partition([(ws, we) for _, ws, we in wins], r1 - r0)
            for _, ws, we in wins:
                assert _partition([(a - ws, b - ws) for a, b in
                                   _warp_rows(ws, we) if a < b], we - ws)
            lanes = [(c, min(c + 2, c1)) for c in range(c0, c0 + 64, 2)
                     if c < c1]
            assert _partition([(a - c0, b - c0) for a, b in lanes], c1 - c0)


@pytest.mark.parametrize("n_simd", [1, 7, 15, 64, 430, 431, 1000])
@pytest.mark.parametrize("n_rows,nb", [(311, 311), (2345, 2345),
                                       (46341, 46341)])
def test_launch_plan_shared_memory_fits_a_block(n_simd, n_rows, nb):
    plan = treduce.launch_plan(n_rows, nb, n_simd, 132)
    rows = plan.rows_per_item
    staged = treduce.ROW_BYTES * rows
    tile = 8 * n_simd * treduce.TILE_COLS
    slots = treduce.SLOT_BYTES * plan.run_slots
    assert plan.smem <= treduce.SMEM_LIMIT < 227 * 1024
    assert 1 <= plan.run_slots <= rows
    assert plan.smem == staged + slots + (tile if plan.route == "shared"
                                          else 0)
    assert (plan.route == "shared") == (
        staged + tile + treduce.SLOT_BYTES * min(rows, treduce.WARPS)
        <= treduce.SMEM_LIMIT)
    # the blocks an SM the launch bounds ask for fit whenever the slots
    # can be cut to fit them
    if plan.run_slots >= min(rows, treduce.WARPS) and \
            plan.smem - slots + treduce.SLOT_BYTES * min(rows, treduce.WARPS) \
            <= treduce.BLOCK_SMEM:
        assert plan.smem <= treduce.BLOCK_SMEM


@pytest.mark.parametrize("n_simd", [1, 7, 15, 64])
@pytest.mark.parametrize("nb", [1, 311, 2345, 100_003])
def test_launch_plan_route_is_shared_for_the_searches_panels(n_simd, nb):
    for n_rows in (1, 311, 2345):
        assert treduce.launch_plan(n_rows, nb, n_simd, 132).route == "shared"


def test_launch_plan_route_is_global_past_the_tile():
    # 256 staged rows, 8 run slots and 430 SIMD rows x 64 columns fit in a
    # block's shared memory, 431 do not; the global route reads them
    # through the cache
    assert treduce.launch_plan(46341, 46341, 430, 132).route == "shared"
    assert treduce.launch_plan(46341, 46341, 431, 132).route == "global"
    assert treduce.launch_plan(3001, 777, 1000, 132).route == "global"


def test_main_path_plans_fill_one_wave():
    """One item a block, four blocks an SM, and every item of the
    128-step lattice's real projection in one window of runs."""
    lattice = treduce.launch_plan(2345, 2345, 15, 132)
    table8 = treduce.launch_plan(311, 311, 7, 132)
    assert lattice.route == table8.route == "shared"
    assert lattice.blocks == lattice.n_items <= 4 * 132
    assert table8.blocks == table8.n_items
    assert lattice.smem <= treduce.BLOCK_SMEM
    s3_of, _ = _main_path_projections(tuple(range(128, 2049, 128)))
    for r0, r1, _, _ in _items(lattice, 2345, 2345)[::lattice.col_tiles]:
        assert len(_windows(s3_of[r0:r1], lattice.run_slots)) == 2  # halves


def test_planner_constants_match_the_source():
    import re
    from repro_torch.kernels import _ext
    src = (_ext.CSRC / treduce.SOURCE).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", src)
                   .group(1))
    assert const("kTile") == treduce.TILE_COLS
    assert const("kMaxItemRows") == treduce.MAX_ITEM_ROWS
    assert const("kThreads") == 32 * treduce.WARPS
    assert f"__launch_bounds__(kThreads, {treduce.BLOCKS_PER_SM})" in src
    fields = [f for f, _ in treduce._CPlan._fields_]
    body = re.sub(r"//.*", "", re.search(r"struct Plan \{(.*?)\};", src,
                                         re.S).group(1))
    assert re.findall(r"(\w+)[,;]", body) == fields
    assert treduce.PARTIAL_BYTES == 4 * 8


# ---- a model of the kernel's walk ------------------------------------------

def _walk_model(conv, simd, s3_of, v_of, plan):
    """The kernel's walk in numpy, lane by lane: items, windows of runs,
    warp slices of each window, the pair of columns a lane owns (the last
    one repeated at a ragged edge), a lane's state started from its first
    candidate and updated by strict compares, then lexicographic merges
    of every lane state.  It checks the algorithm on the CPU; the kernel
    itself is held on the card."""
    nb = conv.shape[1]
    states = []
    for r0, r1, c0, _ in _items(plan, s3_of.shape[0], nb):
        cols = np.arange(c0, c0 + 64, 2)
        cols = cols[cols < nb]
        c_b = np.minimum(cols + 1, nb - 1)          # the lane's second column
        lanes = {}                                  # warp -> [mn, mc, mx, xc]
        for _, ws, we in _windows(s3_of[r0:r1], plan.run_slots):
            for w, (ra, rb) in enumerate(_warp_rows(ws, we)):
                for r in range(ra, rb):
                    s3, v = s3_of[r0 + r], v_of[r0 + r]
                    g = (conv[s3, cols] + simd[v, cols],
                         conv[s3, c_b] + simd[v, c_b])
                    if w not in lanes:              # the first candidate
                        lanes[w] = [g[0], np.full(cols.shape, 2 * r),
                                    g[0], np.full(cols.shape, 2 * r)]
                    st = lanes[w]
                    for j, x in enumerate(g):       # strict
                        lo, hi = x < st[0], x > st[2]
                        st[0], st[1] = np.where(lo, x, st[0]), \
                            np.where(lo, 2 * r + j, st[1])
                        st[2], st[3] = np.where(hi, x, st[2]), \
                            np.where(hi, 2 * r + j, st[3])
        for mn, mc, mx, xc in lanes.values():
            states += list(zip(mn, (r0 + mc // 2) * nb + cols + mc % 2,
                               mx, (r0 + xc // 2) * nb + cols + xc % 2))
    best = min(states, key=lambda s: (s[0], s[1]))
    worst = min(states, key=lambda s: (-int(s[2]), s[3]))
    return np.array([best[0], best[1], worst[2], worst[3]], dtype=np.int64)


def _main_path_projections(values):
    from repro_torch.core import dse
    tuples = dse._tuples(values, 4, 2048 * 0.85, 2048 * 1.15)
    _, s3_of = dse._project(tuples, lambda t: t[:3])
    _, v_of = dse._project(tuples, lambda t: t[3])
    return np.asarray(s3_of, np.int64), np.asarray(v_of, np.int64)


def _table8_case(seed):
    from repro_torch.core import dse
    s3_of, v_of = _main_path_projections(dse.SIZES_KB)
    rng = np.random.default_rng(seed)
    nb = s3_of.shape[0]
    conv = rng.integers(2 ** 31, 2 ** 34, (s3_of.max() + 1, nb), np.int64)
    simd = rng.integers(2 ** 31, 2 ** 34, (v_of.max() + 1, nb), np.int64)
    return conv, simd, s3_of, v_of


_I64 = np.iinfo(np.int64)
MODEL_CASES = dict(CASES, table8_sorted=_table8_case(6),
                   # more runs in an item (38) than run slots: several
                   # windows an item
                   windows=_random_case(8, 300, 420, 20000, 64),
                   all_int64_max=(np.full((2, 33), _I64.max, np.int64),
                                  np.zeros((1, 33), np.int64),
                                  np.array([1, 0, 1], np.int64),
                                  np.zeros(3, np.int64)),
                   all_int64_min=(np.full((2, 33), _I64.min, np.int64),
                                  np.zeros((1, 33), np.int64),
                                  np.array([0, 1, 1], np.int64),
                                  np.zeros(3, np.int64)),
                   table8_ties=(lambda c: (c[0] % 3, c[1] % 2) + c[2:])(
                       _table8_case(7)))


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_walk_model_matches_numpy(name):
    case = MODEL_CASES[name]
    plan = treduce.launch_plan(case[2].shape[0], case[0].shape[1],
                               case[1].shape[0], 132)
    np.testing.assert_array_equal(_walk_model(*case, plan),
                                  _numpy_minmax(*case))


@pytest.mark.parametrize("values,rows,runs,n_simd", [
    ((32, 64, 128, 256, 512, 1024, 2048), 311, 175, 7),
    (tuple(range(128, 2049, 128)), 2345, 680, 15)])
def test_main_path_s3_of_is_sorted_in_runs(values, rows, runs, n_simd):
    """The kernel's speed premise: the searches' ``s3_of`` is sorted, so
    a warp holds a conv element over runs of equal rows (1.78 rows a run
    on the Table VIII lattice, 3.45 on the 128-step one)."""
    s3_of, v_of = _main_path_projections(values)
    assert s3_of.shape == v_of.shape == (rows,)
    assert np.all(np.diff(s3_of) >= 0)
    assert 1 + np.count_nonzero(np.diff(s3_of)) == s3_of.max() + 1 == runs
    assert v_of.max() + 1 == n_simd
    assert rows / runs == pytest.approx({311: 1.777, 2345: 3.449}[rows],
                                        abs=1e-3)


def test_build_is_lazy_and_addressed_by_content():
    from repro_torch.kernels import _ext
    path = _ext.library_path(treduce.SOURCE)
    assert path.parent == _ext.BUILD_DIR
    assert path == _ext.library_path(treduce.SOURCE)
    assert (_ext.CSRC / treduce.SOURCE).is_file()
    assert "sm_90a" in " ".join(_ext.NVCC_FLAGS)
    # importing and reducing on the CPU never built or loaded anything
    assert treduce.SOURCE not in _ext._LIBS
