"""The LM sharding rules on the reference's production meshes, on the CPU.

The reference runs on ``jax.sharding.AbstractMesh`` of the production
shapes (no devices needed); the port on a ``DeviceMesh`` of the same shape
over a fake process group (``launch/mesh.production_mesh``, torn down
after each test).  Held equal, entry for entry:

* ``default_rules``, ``logical_to_pspec`` and ``sanitize_pspec``;
* for every assigned arch, every parameter's sanitized spec and shard
  shape (the reference's stacked-layer leading Nones dropped, a linear
  weight's entries reversed as the port's weight is transposed);
* ``state_pspecs``, ``batch_pspecs`` of the train, prefill and decode
  batches, and ``cache_pspecs`` of every family's caches at both
  ``decode_kv_shard`` values, sanitized by ``to_shardings``.

Beside them: ``constrain`` (a no-op outside the rules and on a plain
tensor, a redistribution of a DTensor), the dry run's rank counter
(``launch/dryrun.RankCounts``): its collective bytes against the
reference's ``collective_bytes`` on hand-written HLO of the same
collectives, and its FLOPs, peak and collective bytes of a sharded step on
fake tensors against the hand-counted local numbers, and the attention
ops' DTensor sharding rules on real tensors over a fake mesh.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.analysis import roofline as j_rl
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_sharding
from repro.launch import shardings as j_sh
from repro.launch import specs as j_specs
from repro.models import model as j_model
from repro.training import train_loop as j_train_loop
from repro_torch.analysis import roofline as rl
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.training import train_loop

MESHES = {"pod16x16": False, "pod2x16x16": True}


@pytest.fixture(params=list(MESHES))
def meshes(request):
    """(the port's fake ``cpu`` mesh, the reference's abstract mesh)."""
    multi_pod = MESHES[request.param]
    shape, axes = mesh_lib.PRODUCTION[multi_pod]
    with mesh_lib.production_mesh(multi_pod=multi_pod, device="cpu") as mesh:
        yield mesh, jax.sharding.AbstractMesh(shape, axes)


def _spec(s) -> tuple:
    return tuple(s)


def _drop(ref_spec, ref_ndim: int, port_ndim: int, weight=False) -> tuple:
    """The reference's spec of a stacked leaf as the port's leaf's."""
    spec = tuple(ref_spec) + (None,) * (ref_ndim - len(ref_spec))
    stacked, spec = spec[:ref_ndim - port_ndim], spec[ref_ndim - port_ndim:]
    assert all(s is None for s in stacked), ref_spec
    return spec[::-1] if weight else spec


def _drop_shape(shape, port_ndim: int, weight=False) -> tuple:
    shape = tuple(shape)[len(shape) - port_ndim:]
    return shape[::-1] if weight else shape


def test_rules_and_pspecs_match_the_references(meshes):
    mesh, jmesh = meshes
    rules, jrules = sharding.default_rules(mesh), j_sharding.default_rules(jmesh)
    assert rules == jrules
    for names in [("batch", None, None), ("batch", "seq_res", "model"), ("fsdp", "expert"),
                  ("batch", ("data",), None), ()]:
        assert _spec(sharding.logical_to_pspec(names, rules)) == \
            _spec(j_sharding.logical_to_pspec(names, jrules))
    for spec, shape in [(("data", "model"), (2304, 9216)), (("model", None), (8, 768)),
                        ((rules["batch"], None), (64, 3)), ((rules["batch"], None), (16, 3)),
                        ((("data", "model"),), (96,)), ((None, "model", None), (4, 2, 16)),
                        (("model",), ())]:
        assert _spec(sharding.sanitize_pspec(spec, shape, mesh)) == \
            _spec(j_sharding.sanitize_pspec(JP(*spec), shape, jmesh))
    assert sharding.P("data", None) == ("data", None)


ASSIGNED = dryrun.ASSIGNED


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_and_state_shardings_match_the_references(arch, meshes):
    mesh, jmesh = meshes
    cfg, jcfg = get_config(arch), j_get_config(arch)
    module, pspecs = model_lib.abstract_init(model_lib.build(cfg))
    named = dict(module.named_parameters())
    structs, jspecs = j_model.abstract_init(j_model.build(jcfg))
    leaves, tree = jax.tree.flatten(structs)
    spec_leaves = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, JP))
    ids = jax.tree.unflatten(tree, [np.broadcast_to(np.int64(i), l.shape)
                                    for i, l in enumerate(leaves)])
    carried = convert.named_arrays(cfg, ids)
    got = sharding.param_shardings(mesh, pspecs, named)
    jsan = j_sharding.sanitize_tree(jspecs, structs, jmesh)
    jsan_leaves = jax.tree.leaves(jsan, is_leaf=lambda x: isinstance(x, JP))
    for name, p in named.items():
        i = int(carried[name].flat[0])
        weight = name.endswith(".weight")
        want = _drop(jsan_leaves[i], len(leaves[i].shape), p.dim(), weight)
        assert _spec(got[name].spec) == want, name
        jshape = JNamedSharding(jmesh, jsan_leaves[i]).shard_shape(leaves[i].shape)
        assert got[name].shard_shape(p.shape) == _drop_shape(jshape, p.dim(), weight), name
        assert _drop(spec_leaves[i], len(leaves[i].shape), p.dim(), weight) == pspecs[name]
    state = train_loop.state_pspecs(pspecs)
    jstate = j_train_loop.state_pspecs(jspecs)
    assert state.params is pspecs and state.opt.mu is pspecs and state.opt.nu is pspecs
    assert _spec(state.opt.step) == _spec(jstate.opt.step) == ()


def _batches(cfg, jcfg):
    for name, shape in SHAPES.items():
        if shape.kind == "decode":
            yield name, specs.decode_batch(cfg, shape), j_specs.decode_batch(jcfg, shape)
        else:
            yield name, specs.train_batch(cfg, shape), j_specs.train_batch(jcfg, shape)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_batch_pspecs_match_the_references(arch, meshes):
    mesh, jmesh = meshes
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert sh.batch_axes_of(mesh, cfg) == j_sh.batch_axes_of(jmesh, jcfg)
    for name, batch, jbatch in _batches(cfg, jcfg):
        got = sh.batch_pspecs(cfg, batch, mesh)
        want = j_sh.batch_pspecs(jcfg, jbatch, jmesh)
        shard = sh.to_shardings(mesh, got, batch)
        jshard = j_sh.to_shardings(jmesh, want, jbatch)
        assert set(got) == set(want), name
        for k in got:
            assert _spec(got[k]) == _spec(want[k]), (name, k)
            assert _spec(shard[k].spec) == _spec(jshard[k].spec), (name, k)
            assert shard[k].shard_shape(batch[k].shape) == \
                jshard[k].shard_shape(jbatch[k].shape), (name, k)


def _cache_pairs(fam, got, want, caches, jcaches, pattern_len):
    """(port spec, port leaf, reference spec, reference leaf) for each
    cache leaf; the reference stacks what the port lists."""
    flat = lambda t: jax.tree.leaves(t, is_leaf=lambda x: isinstance(x, JP))  # noqa: E731
    pairs = []

    def add(port_specs, port_leaves, ref_specs, ref_leaves):
        ps = [s for s in flat(port_specs)]
        pl = [x for x in jax.tree.leaves(port_leaves, is_leaf=lambda x: x is None)]
        rs, rl_ = flat(ref_specs), jax.tree.leaves(ref_leaves)
        assert len(ps) == len(pl) == len(rs) == len(rl_)
        pairs.extend(zip(ps, pl, rs, rl_))

    if fam in ("dense", "moe", "vlm"):
        for i, (s, c) in enumerate(zip(got, caches)):
            add(s, c, want[i % pattern_len], jcaches[i % pattern_len])
    elif fam == "xlstm":
        for i, (s_reps, c_reps) in enumerate(zip(got, caches)):
            for s, c in zip(s_reps, c_reps):
                add(s, c, want[i], jcaches[i])
    elif fam == "hybrid":
        for s_grp, c_grp in zip(got["mamba"], caches["mamba"]):
            for s, c in zip(s_grp, c_grp):
                add(s, c, want["mamba"], jcaches["mamba"])
        for s, c in zip(got["attn"], caches["attn"]):
            add(s, c, want["attn"], jcaches["attn"])
    else:
        for s, c in zip(got["attn"], caches["attn"]):
            add(s, c, want["attn"], jcaches["attn"])
        add(got["memory"], caches["memory"], want["memory"], jcaches["memory"])
    return pairs


@pytest.mark.parametrize("kv", ["heads", "seq"])
@pytest.mark.parametrize("arch", ASSIGNED)
def test_cache_pspecs_match_the_references(arch, kv, meshes):
    mesh, jmesh = meshes
    cfg = get_config(arch).replace(decode_kv_shard=kv)
    jcfg = j_get_config(arch).replace(decode_kv_shard=kv)
    shape = SHAPES["decode_32k"]
    caches = specs.cache_specs(cfg, shape, model_lib.build(cfg))
    jcaches = j_specs.cache_specs(jcfg, shape, j_model.build(jcfg))
    got = sh.cache_pspecs(cfg, caches, mesh)
    want = j_sh.cache_pspecs(jcfg, jcaches, jmesh)
    shard = jax.tree.map(lambda s: s.spec, sh.to_shardings(mesh, got, caches),
                         is_leaf=lambda x: isinstance(x, sharding.NamedSharding))
    jshard = j_sh.to_shardings(jmesh, want, jcaches)
    jshard = jax.tree.map(lambda s: s.spec, jshard,
                          is_leaf=lambda x: isinstance(x, JNamedSharding))
    pattern_len = len(jcaches) if cfg.family in ("dense", "moe", "vlm") else 1
    pairs = _cache_pairs(cfg.family, got, want, caches, jcaches, pattern_len)
    san = _cache_pairs(cfg.family, shard, jshard, caches, jcaches, pattern_len)
    assert pairs
    for (s, leaf, js, jleaf), (ss, _, jss, _) in zip(pairs, san):
        ndim = getattr(leaf, "ndim", 0)
        assert _spec(s) == _drop(js, jleaf.ndim, ndim), (s, js)
        assert _spec(ss) == _drop(jss, jleaf.ndim, ndim), (ss, jss)
        if ndim:
            want_shape = JNamedSharding(jmesh, jss).shard_shape(jleaf.shape)
            assert sharding.NamedSharding(mesh, ss).shard_shape(leaf.shape) == \
                _drop_shape(want_shape, ndim)


def test_constrain_is_a_no_op_off_the_rules_and_redistributes_a_dtensor(meshes):
    mesh, _ = meshes
    x = torch.randn(32, 4, 32)
    assert sharding.constrain(x, ("batch", None, None)) is x
    with sharding.axis_rules(mesh):
        assert sharding.constrain(x, ("batch", None, None)) is x
        d = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
        y = sharding.constrain(d, ("batch", None, "model"))
        want = sharding.NamedSharding(mesh, sharding.logical_to_pspec(
            ("batch", None, "model"), sharding.current_rules()[1]))
        assert tuple(y.placements) == want.placements
        assert tuple(y.to_local().shape) == want.shard_shape(x.shape)
        assert sharding.constrain(y, ("batch", None, "model")) is y
        # a dim the axes do not divide keeps the prefix that divides it
        z = sharding.constrain(d[:, :, :8], ("batch", None, "model"))
        assert tuple(z.placements) == sharding.NamedSharding(
            mesh, want.spec[:2] + (None,)).placements
    assert sharding.current_rules() is None
    d = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    assert sharding.constrain(d, ("batch", None, None)) is d


def _hlo(lines: list[str]) -> str:
    body = "\n".join(f"  {line}" for line in lines)
    return f"HloModule m\n\nENTRY %main {{\n{body}\n}}\n"


def test_collective_bytes_follow_the_references_convention():
    """An all-gather, a reduce-scatter and an all-reduce over a fake
    16-rank mesh count, per device and by kind, what the reference's
    parser counts for the same collectives in HLO."""
    with mesh_lib.production_mesh(device="cpu"):
        mesh = mesh_lib.make_test_mesh((16,), ("model",), device="cpu")
        x = torch.randn(64, 128, dtype=torch.bfloat16)
        sharded = distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)
        partial = DTensor.from_local(torch.randn(64, 128), mesh,
                                     [sharding.Partial()], run_check=False)
        with dryrun.RankCounts() as counted:
            sharded.redistribute(mesh, [Replicate()])
            partial.redistribute(mesh, [Shard(0)])
            partial.redistribute(mesh, [Replicate()])
    hlo = _hlo([
        "%p0 = bf16[4,128]{1,0} parameter(0)",
        "%p1 = f32[64,128]{1,0} parameter(1)",
        "%ag = bf16[64,128]{1,0} all-gather(bf16[4,128]{1,0} %p0), "
        "replica_groups=[1,16]<=[16], dimensions={0}",
        "%rs = f32[4,128]{1,0} reduce-scatter(f32[64,128]{1,0} %p1), "
        "replica_groups=[1,16]<=[16], dimensions={0}, to_apply=%add",
        "ROOT %ar = f32[64,128]{1,0} all-reduce(f32[64,128]{1,0} %p1), "
        "replica_groups=[1,16]<=[16], to_apply=%add"])
    want = j_rl.collective_bytes(hlo)
    assert set(rl.COLLECTIVES) == set(j_rl._COLLECTIVES) == set(counted.coll)
    assert counted.coll == want
    assert want["all-gather"] == 1024 and want["reduce-scatter"] == want["all-reduce"] == 32768


@pytest.mark.parametrize("steps", [1, 4])
def test_rank_counts_are_one_ranks_local_work(steps):
    """Steps on fake tensors over the fake 256-rank mesh, as the dry run
    traces them: x [256, 512] on 'data' times an FSDP weight [512, 1024]
    on ('data', 'model') gathered over 'data'.  Rank 0's FLOPs, peak and
    collective bytes are the local shapes' (x [16, 512], the weight's
    shard [32, 64] gathered to [512, 64], y [16, 64]): not the global
    shapes DTensor propagates, and the gathered weight counted once."""
    f32 = 4
    with mesh_lib.production_mesh(device="cpu") as mesh:
        fake = FakeTensorMode()
        with fake:
            x = sharding.distribute(torch.empty(256, 512),
                                    sharding.NamedSharding(mesh, sharding.P("data", None)))
            w = sharding.distribute(torch.empty(512, 1024),
                                    sharding.NamedSharding(mesh, sharding.P("data", "model")))
        counted = dryrun.RankCounts()
        held = counted.hold((x, w))
        assert held == (16 * 512 + 32 * 64) * f32
        with dryrun._fake_safe_strided_shards(), fake, counted, \
                sharding.axis_rules(mesh):
            for _ in range(steps):
                y = x @ sharding.gather_fsdp(w)
                assert tuple(y.to_local().shape) == (16, 64)
                del y
        # every step's storages died: their bytes are free again, and a
        # later step's storages (their addresses reused) count afresh
        assert counted.live == held
    assert counted.flops == counted.flops_by_op["aten.mm"] == steps * 2 * 16 * 512 * 64
    assert counted.coll == dict(dict.fromkeys(rl.COLLECTIVES, 0),
                                **{"all-gather": steps * 32 * 64 * f32})
    assert counted.peak == (16 * 512 + 32 * 64 + 512 * 64 + 16 * 64) * f32


def _attn_case(B, Hq, Hkv, S, D, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, S, D, generator=g)
    k, v = (torch.randn(B, Hkv, S, D, generator=g) for _ in range(2))
    do = torch.randn(B, Hq, S, D, generator=g)
    return q, k, v, do


@pytest.mark.parametrize("layout", ["batch", "heads"])
def test_attention_ops_shard_batch_and_heads(layout):
    """q/k/v sharded on the batch (over 'data') or the heads (over
    'model') give rank 0 the plain version's slice of ``o`` and of dq, dk
    and dv; no collective is issued."""
    with mesh_lib.production_mesh(device="cpu"):
        mesh = mesh_lib.make_test_mesh((2, 4), ("data", "model"), device="cpu")
        q, k, v, do = _attn_case(4, 8, 4, 16, 16, seed=3)
        dim = 0 if layout == "batch" else 1
        place = [Shard(0), Replicate()] if layout == "batch" else [Replicate(), Shard(1)]
        dq_, dk_, dv_, ddo = (distribute_tensor(t, mesh, place, src_data_rank=None)
                              for t in (q, k, v, do))
        for t in (dq_, dk_, dv_):
            t.requires_grad_(True)
        with dryrun.RankCounts() as counted:
            o = flash_ops.attention(dq_, dk_, dv_, causal=True, window=5, softcap=30.0)
            grads = torch.autograd.grad(o, (dq_, dk_, dv_), ddo)
        assert tuple(o.placements) == tuple(place)
        qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
        o_ref = ref.attention_ref(qr, kr, vr, causal=True, window=5, softcap=30.0)
        g_ref = torch.autograd.grad(o_ref, (qr, kr, vr), do)

        def rank0(t):
            return t.detach().narrow(dim, 0, t.shape[dim] // mesh.size(dim)).numpy()

        np.testing.assert_allclose(o.to_local().detach().numpy(), rank0(o_ref),
                                   atol=2e-5, rtol=2e-5)
        for got, want in zip(grads, g_ref):
            assert tuple(got.placements) == tuple(place)
            np.testing.assert_allclose(got.to_local().numpy(), rank0(want),
                                       atol=2e-5, rtol=2e-5)
        assert sum(counted.coll.values()) == 0


def test_attention_ops_replicate_an_indivisible_gqa_split():
    """Hkv = 2 on a 4-wide 'model' axis: heads cannot shard, so DTensor
    gathers the head-sharded inputs and the output is replicated."""
    with mesh_lib.production_mesh(device="cpu"):
        mesh = mesh_lib.make_test_mesh((2, 4), ("data", "model"), device="cpu")
        q, k, v, _ = _attn_case(2, 8, 2, 16, 16, seed=4)
        qd = distribute_tensor(q, mesh, [Replicate(), Shard(1)], src_data_rank=None)
        kd, vd = (distribute_tensor(t, mesh, [Replicate(), Replicate()], src_data_rank=None)
                  for t in (k, v))
        with dryrun.RankCounts() as counted:
            o = flash_ops.attention(qd, kd, vd)
        assert tuple(o.placements) == (Replicate(), Replicate())
        assert tuple(o.to_local().shape) == tuple(q.shape)
        assert counted.coll["all-gather"] == q.numel() * 4 // 4


def test_production_mesh_owns_its_fake_group(tmp_path):
    """A fake group of another size is replaced, ``release`` tears it down,
    and a group that is not fake makes the production mesh raise."""
    import torch.distributed as dist

    mesh = mesh_lib.make_production_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and dist.get_world_size() == 256
    mesh = mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
    assert mesh.shape == (2, 16, 16) and dist.get_world_size() == 512
    mesh_lib.release()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="'gloo' process group"):
            mesh_lib.make_production_mesh(device="cpu")
        mesh_lib.release()
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
