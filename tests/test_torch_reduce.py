"""The port's grid min/max reduction against the JAX package's Pallas kernel.

``repro_torch.kernels.reduce.grid_minmax_ref`` (what ``grid_minmax`` runs
on a CPU tensor) is held to ``repro.kernels.reduce.grid_minmax_pallas`` in
interpret mode and to numpy, exactly (tolerance 0: int64 in, int64 out),
on grids past 2**31, on tie grids and on degenerate shapes.  The CUDA
kernel itself is held to ``grid_minmax_ref`` on the card by
``chip_smoke.py``.
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


@pytest.mark.parametrize("n_rows", [1, 2, 131, 132, 528, 529, 2345, 96721])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_launch_shape_covers_every_row_once(n_rows, n_sm):
    rows_per_block, n_blocks = treduce.launch_shape(n_rows, n_sm)
    assert rows_per_block >= 1
    assert n_blocks * rows_per_block >= n_rows
    assert (n_blocks - 1) * rows_per_block < n_rows
    assert n_blocks <= treduce.BLOCKS_PER_SM * n_sm


def test_build_is_lazy_and_addressed_by_content():
    from repro_torch.kernels import _ext
    path = _ext.library_path(treduce.SOURCE)
    assert path.parent == _ext.BUILD_DIR
    assert path == _ext.library_path(treduce.SOURCE)
    assert (_ext.CSRC / treduce.SOURCE).is_file()
    assert "sm_90a" in " ".join(_ext.NVCC_FLAGS)
    # importing and reducing on the CPU never built or loaded anything
    assert treduce.SOURCE not in _ext._LIBS
