"""The int8 compressed mean-all-reduce and the hash screen over a mesh, on
the CPU, against the reference.

* ``quantize`` and ``compressed_psum_mean`` in one process against the
  reference's: seeded inputs, ±127 clipping, ties at .5 (half to even), a
  zero gradient (the 1e-12 floor of the scale), on a one-rank group.
* In one spawned 8-rank ``gloo`` world
  (``torch_mesh_worker.compression_screen_rank``): ``compressed_psum_mean``
  a row a rank, with and without the error buffer, byte-equal to the
  reference's ``vmap`` over the same 8 rows (``vmap`` takes ``pmax`` and
  ``psum`` over its axis); the reference's convergence drill (300 steps of
  the distributed least squares, final MSE under 1e-3); and the
  reference's sharded hash screen (64 patients, ``avg_events=16``, seed
  4, ``mine_triangular``, threshold 3, H = 18, patient-sharded over 8
  ranks) byte-equal to its global ``screen_hash``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_worker
from repro.core import mining as j_mining
from repro.core import sparsity as j_sparsity
from repro.data import dbmart as j_dbmart
from repro.data import synthea as j_synthea
from repro.distributed import compression as j_comp
from repro_torch.core import mining
from repro_torch.data import dbmart, synthea
from repro_torch.distributed import compression, sharding
from repro_torch.launch.mesh import make_test_mesh

WORLD = 8
SCREEN = {"n_patients": 64, "avg_events": 16, "seed": 4, "threshold": 3, "H": 18}


def _rows(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((WORLD, 16)) * rng.uniform(0.01, 10, (WORLD, 1)))
    e = rng.standard_normal((WORLD, 16)) * 1e-3
    return g.astype(np.float32), e.astype(np.float32)


def _ref_means(g, e=None):
    """The reference's mean and new error of each row, the rows reduced
    over ``vmap``'s axis."""
    if e is None:
        fn = jax.vmap(lambda g: j_comp.compressed_psum_mean(g, "pod"), axis_name="pod")
        out = fn(jnp.asarray(g))
    else:
        fn = jax.vmap(lambda g, e: j_comp.compressed_psum_mean(g, "pod", e),
                      axis_name="pod")
        out = fn(jnp.asarray(g), jnp.asarray(e))
    return tuple(np.asarray(t) for t in out)


def _same_bytes(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.ascontiguousarray(want).tobytes(), \
        np.abs(got.astype(np.float64) - want).max()


# ---- one process ------------------------------------------------------------

EDGE_SCALES = [(np.float32(1.0), [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.0,
                                  127.49, 127.5, 128.0, -127.5, -128.0, 1e6, -1e6, 0.0,
                                  -0.0, 3.4999998, 1e-45]),
               (np.float32(1e-12 / 127.0), [0.0, 1e-12, -1e-12, 5e-15, 3e-15, 1e-30]),
               (np.float32(0.1), [0.05, 0.15, 0.25, 12.65, -12.75, 12.7, 12.75])]


@pytest.mark.parametrize("case", range(len(EDGE_SCALES)))
def test_quantize_matches_the_reference_at_edge_values(case):
    """Clipping at ±127, ties at .5 (half to even: ``torch.round`` as
    ``jnp.round``), zeros, and scales at the 1e-12 floor."""
    scale, xs = EDGE_SCALES[case]
    x = np.asarray(xs, np.float32)
    want = np.asarray(j_comp.quantize(jnp.asarray(x), jnp.float32(scale)))
    got = compression.quantize(torch.from_numpy(x), torch.tensor(scale))
    _same_bytes(got, want)


def test_quantize_matches_the_reference_on_seeded_rows():
    g, _ = _rows(0)
    for row in g:
        scale = np.float32(np.maximum(np.abs(row).max(), np.float32(1e-12)) / np.float32(127))
        want = np.asarray(j_comp.quantize(jnp.asarray(row), jnp.float32(scale)))
        _same_bytes(compression.quantize(torch.from_numpy(row), torch.tensor(scale)), want)


@pytest.fixture
def one_rank_pod(tmp_path):
    """A one-rank ``gloo`` group and its ``('pod',)`` mesh's rules."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        with sharding.axis_rules(make_test_mesh((1,), ("pod",), device="cpu")):
            yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["zeros", "seeded", "seeded_err", "clipped_err"])
def test_compressed_psum_mean_on_one_rank_matches_the_reference(one_rank_pod, kind):
    """A one-row mean (the reference's ``vmap`` over one row): a zero
    gradient takes the 1e-12 floor and gives zeros; an error buffer that
    outgrows the gradient."""
    g, e = _rows(1)
    g, e = g[:1], e[:1]
    if kind == "zeros":
        g, e = np.zeros_like(g), None
    elif kind == "seeded":
        e = None
    elif kind == "clipped_err":
        e = e * 1e4
    want = _ref_means(g, e)
    got = compression.compressed_psum_mean(
        torch.from_numpy(g[0]), "pod", None if e is None else torch.from_numpy(e[0]))
    for t, w in zip(got, want):
        _same_bytes(t, w[0])


def test_tree_compressed_psum_mean_maps_over_the_tree(one_rank_pod):
    """The tree version against the reference's on a nested tree (dicts
    and a list: the reference takes every tuple for a (mean, error) pair),
    without and with the error tree."""
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  {"c": rng.standard_normal((2, 2)).astype(np.float32)}]}
    errs = jax.tree.map(lambda x: (x * 1e-3).astype(np.float32), tree)
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    for err in (None, errs):
        fn = jax.vmap(lambda g, e: j_comp.tree_compressed_psum_mean(g, "pod", e),
                      axis_name="pod")
        batched = jax.tree.map(lambda x: x[None], tree)
        want = fn(batched, None if err is None else jax.tree.map(lambda x: x[None], err))
        got = compression.tree_compressed_psum_mean(to_t(tree), "pod",
                                                    None if err is None else to_t(err))
        for part in (0, 1):
            got_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got[part]))
            for g_leaf, w_leaf in zip(got_leaves, jax.tree.leaves(want[part])):
                assert g_leaf.tobytes() == np.asarray(w_leaf)[0].tobytes()
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got[0])) \
            == jax.tree.structure(jax.tree.map(lambda t: 0, tree))


def test_compressed_psum_mean_needs_the_rules():
    with pytest.raises(RuntimeError, match="axis_rules"):
        compression.compressed_psum_mean(torch.ones(3), "pod")


# ---- an 8-rank world ---------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's results, and what rank 0 of the 8-rank world
    gathered."""
    tmp = tmp_path_factory.mktemp("compression_world")
    g, e = _rows(3)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((64, 16)).astype(np.float32)
    w_true = rng.standard_normal(16).astype(np.float32)
    c = SCREEN
    pats, dates, phx, _ = j_synthea.generate_cohort(n_patients=c["n_patients"],
                                                    avg_events=c["avg_events"], seed=c["seed"])
    jdb = j_dbmart.from_rows(pats, dates, phx)
    jmined = j_mining.mine_triangular(jdb.phenx, jdb.date, jdb.nevents)
    ref = {"plain": _ref_means(g), "err": _ref_means(g, e),
           "keep": np.asarray(j_sparsity.screen_hash(jmined.seq, jmined.mask, c["threshold"],
                                                     n_buckets_log2=c["H"]))}
    pats, dates, phx, _ = synthea.generate_cohort(n_patients=c["n_patients"],
                                                  avg_events=c["avg_events"], seed=c["seed"])
    db = dbmart.from_rows(pats, dates, phx)
    mined = mining.mine_triangular(db.phenx, db.date, db.nevents)
    data = {"g": torch.from_numpy(g), "e": torch.from_numpy(e), "X": torch.from_numpy(X),
            "y": torch.from_numpy(X @ w_true), "seq": mined.seq, "mask": mined.mask,
            "threshold": c["threshold"], "H": c["H"]}
    return ref, torch_mesh_worker.spawn(torch_mesh_worker.compression_screen_rank, WORLD,
                                        tmp, data)


@pytest.mark.parametrize("key", ["plain", "err"])
def test_compressed_psum_mean_over_8_ranks_is_the_references(world, key):
    """Every rank's mean and new error byte-equal to the reference's row."""
    ref, got = world
    mean, err = got[key]
    want_mean, want_err = ref[key]
    _same_bytes(mean, want_mean)
    _same_bytes(err, want_err)
    assert (mean == mean[0]).all()


def test_compressed_psum_convergence(world):
    _, got = world
    assert got["mse"] < 1e-3, got["mse"]


def test_sharded_hash_screen_matches_the_references_global_screen(world):
    ref, got = world
    keep = got["keep"].numpy()
    assert keep.dtype == ref["keep"].dtype and keep.shape == ref["keep"].shape
    assert (keep == ref["keep"]).all(), "patient-sharded screen != global screen"
    assert keep.sum() > 0
