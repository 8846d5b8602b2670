"""The port's dry run (``launch/{dryrun,probes,hlo_stats}.py``), the
configs it needs and the sharded serving steps, against ``repro``:

* (a) the dot-product FLOPs of every probe and of the whole step equal
  those of ``repro``'s own code exactly, for a reduced arch of each family
  at train, prefill and decode (remat on and off, chunked attention
  once). The reference is a walk of ``jax.make_jaxpr`` of ``repro``'s
  step and of ``repro.launch.probes.probes_for``'s functions, dead code
  removed first (XLA removes it too), summing ``dot_general`` and
  ``conv_general_dilated`` at 2 per multiply-add, a ``scan`` body times
  its length, a ``while`` refused; an einsum that sums no index (rwkv6's
  outer product) is traced as the multiply torch's einsum runs. A torch gradient runs the whole
  forward it differentiates, which ``jax.grad``'s jaxpr drops (all of it
  under remat, the dots no gradient needs without) when only the
  gradients are returned: a train probe's reference is ``repro``'s
  ``_grad_wrap`` of the layer's body (the prefill probe's function at
  the same rows) with ``jax.value_and_grad`` in place of ``jax.grad``;
* (b) the dense decoder's step at L layers less the step at 1 layer is
  (L - 1) layer probes;
* (c) a forward probe's ``flops`` within 6 % of ``repro``'s
  ``hlo_stats.cost_stats`` of the compiled probe; ``bytes`` and the
  elementwise count of a two-op function by hand;
* (d) on a fake (2, 2) mesh a ZeRO-3 dense train step's all-gather and
  reduce-scatter bytes equal those worked out from ``state_shardings``
  and the weights the step reads, plus those of its rows over "model";
  the per-kind rule;
* (e) memory: the fake count of a reduced train step equals the same
  tracker on the real CPU run key by key; ``argument_bytes`` is the
  state's and the batch's bytes per rank; a budget below the one-slice
  footprint picks the first microbatch count that fits;
* (f) ``cells()``, the shapes, ``active_params`` and ``input_specs``
  equal ``repro``'s; a record's keys are ``repro``'s plus
  ``gate_is_whole_step``;
* (g) ``make_prefill(batch_chunks=2)`` equals ``repro``'s on carried
  weights; the sharded prefill and lockstep decode on (2, 1) and (1, 2)
  gloo meshes equal mesh-free within fp32 sum order (two spawns of this
  file run as a script, ``python tests/test_torch_dryrun.py RANK WORLD
  DIR``).

Tests never import ``repro.launch.dryrun``: it sets ``XLA_FLAGS`` for
512 host devices when imported."""
import dataclasses
import datetime
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2.5-32b", "dbrx-132b", "llama-3.2-vision-11b",
            "whisper-large-v3", "rwkv6-7b", "hymba-1.5b")
KINDS = ("train", "prefill", "decode")
FLOPS_TOL = 0.06
SERVE_TOL = 1e-4


# ------------------------------------------------------------- helpers
def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _tmodel(arch, **over):
    from repro_torch import configs
    from repro_torch.models.registry import get_model, reduced_config
    return get_model(reduced_config(configs.get_config(arch), **over))


def _jmodel(arch, **over):
    from repro import configs
    from repro.models.registry import get_model, reduced_config
    return get_model(reduced_config(configs.get_config(arch), **over))


def _shapes(kind, S=16, B=4):
    from repro.configs.base import ShapeConfig as J
    from repro_torch.configs import ShapeConfig as T
    return J("t", S, B, kind), T("t", S, B, kind)


def _dce(jaxpr):
    from jax._src.interpreters import partial_eval as pe
    return pe.dce_jaxpr(jaxpr, [True] * len(jaxpr.outvars))[0]


def _dots(jaxpr) -> int:
    """Dot-product FLOPs of a jaxpr, sub-jaxprs included, a scan body
    times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        if p == "while":
            raise AssertionError("a while loop: its trip count is unknown")
        if p == "dot_general":
            (_, rc), (_, rb) = eqn.params["dimension_numbers"]
            n = 2 * int(np.prod(eqn.invars[0].aval.shape))
            for i, d in enumerate(eqn.invars[1].aval.shape):
                if i not in rc and i not in rb:
                    n *= d
            total += n
        elif p == "conv_general_dilated":
            out = eqn.outvars[0].aval.shape
            rhs = eqn.invars[1].aval.shape
            total += 2 * int(np.prod(out)) * int(np.prod(rhs[1:]))
        mult = eqn.params.get("length", 1) if p == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if hasattr(sub, "eqns"):
                    total += mult * _dots(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    total += mult * _dots(sub.jaxpr)
    return total


def _einsum_as_torch(einsum):
    """``jnp.einsum`` that computes a two-operand einsum summing no index
    (an outer product: rwkv6's k v^T in every step) as torch's einsum
    does, a broadcast multiply. ``jnp.einsum`` makes it a
    ``dot_general`` that contracts nothing, and its gradient two dots
    that do; torch's gradient of the multiply is multiplies and sums."""
    import jax.numpy as jnp

    def run(spec, *ops, **kw):
        if (isinstance(spec, str) and len(ops) == 2 and "->" in spec
                and "." not in spec):
            ins, out = spec.replace(" ", "").split("->")
            idx = ins.split(",")
            if (all(len(set(i)) == len(i) for i in idx)
                    and set("".join(idx)) <= set(out)):
                def to_out(x, i):
                    order = sorted(i, key=out.index)
                    x = jnp.transpose(x, [i.index(c) for c in order])
                    return jnp.expand_dims(x, tuple(
                        n for n, c in enumerate(out) if c not in i))
                y = to_out(ops[0], idx[0]) * to_out(ops[1], idx[1])
                dt = kw.get("preferred_element_type")
                return y if dt is None else y.astype(dt)
        return einsum(spec, *ops, **kw)
    return run


def _jcount(fn, *args) -> int:
    """Dot FLOPs of ``repro``'s ``fn`` traced with its outer products as
    torch computes them (:func:`_einsum_as_torch`)."""
    import jax
    import jax.numpy as jnp
    einsum = jnp.einsum
    jnp.einsum = _einsum_as_torch(einsum)
    try:
        return _dots(_dce(jax.make_jaxpr(fn)(*args).jaxpr))
    finally:
        jnp.einsum = einsum


def _jstep(model, shape, mb, remat):
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.optim.adamw import AdamW
    from repro.optim.schedules import cosine
    attn = "chunked" if shape.seq_len >= 2048 else "einsum"
    batch = model.input_specs(shape)
    if shape.kind == "train":
        opt = AdamW(learning_rate=cosine(3e-4, 100, 10000))
        state = jax.eval_shape(
            lambda k: jsteps.init_train_state(model, opt, k),
            jax.random.PRNGKey(0))
        return _jcount(jsteps.make_train_step(
            model, opt, attn_impl=attn, remat=remat, microbatches=mb),
            state, batch)
    params = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
        if jnp.issubdtype(s.dtype, jnp.floating) else s,
        jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    if shape.kind == "prefill":
        return _jcount(jsteps.make_prefill(model, attn_impl=attn,
                                           batch_chunks=mb), params, batch)
    cache = jax.eval_shape(lambda: model.init_cache(
        shape.global_batch, shape.seq_len, jnp.bfloat16))
    return _jcount(jsteps.make_decode_step(model), params, cache, batch)


def _jprobes(model, shape, mb, remat):
    """[(name, mult, dot FLOPs)] of ``repro``'s probes; a train probe is
    counted with its value kept (module docstring)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import probes as jprobes
    from repro.launch import steps as jsteps
    cfg = model.cfg
    attn = "banded" if cfg.window else "einsum"
    probes = jprobes.probes_for(
        model, shape, attn_impl=attn,
        remat=remat if shape.kind == "train" else False, microbatches=mb)
    if shape.kind != "train":
        return [(p.name, p.mult, _jcount(p.fn, *p.args)) for p in probes]
    # the layer bodies: the prefill probes' functions at the same rows
    fwd = {p.name: p.fn for p in jprobes.probes_for(
        model, dataclasses.replace(shape, kind="prefill"), attn_impl=attn,
        remat=False, microbatches=mb)}
    tied = cfg.tie_embeddings or cfg.family.value == "encdec"
    fwd["head_ce"] = lambda x, w, lab: jsteps.head_ce_chunk(
        x, w, lab, cfg.vocab_size, tied)
    policy = jax.checkpoint_policies.nothing_saveable

    def value_and_grads(f, rematted):
        inner = jax.checkpoint(f, policy=policy) if rematted else f

        def probe(x, w, *rest):
            return jax.value_and_grad(
                lambda x, w: jnp.sum(inner(x, w, *rest).astype(jnp.float32)),
                argnums=(0, 1))(x, w)
        return probe
    return [(p.name, p.mult,
             _jcount(value_and_grads(fwd[p.name],
                                     remat or p.name == "head_ce"), *p.args))
            for p in probes]


def _tstep(model, shape, mb, remat, mesh=None):
    from repro_torch.launch import dryrun
    with _fake():
        step, args = dryrun.build_gate(model, shape, mesh, microbatches=mb,
                                       remat=remat)
        return dryrun.count_step(step, args)


def _tprobes(model, shape, mb, remat):
    from repro_torch.launch import hlo_stats, probes
    attn = "banded" if model.cfg.window else "einsum"
    out = []
    with _fake():
        for p in probes.probes_for(
                model, shape, attn_impl=attn,
                remat=remat if shape.kind == "train" else False,
                microbatches=mb):
            counter = hlo_stats.OpCounter()
            with counter:
                p.fn(*p.args)
            out.append((p.name, p.mult, counter.dot_flops))
    return out


# ------------------------------------------------------------- (a), (b)
CASES = ([(a, k, 16, "nothing") for a in FAMILIES for k in KINDS]
         + [("qwen2.5-32b", "train", 16, False),
            ("qwen2.5-32b", "train", 2048, "nothing")])


@pytest.mark.parametrize("arch,kind,seq,remat", CASES)
def test_dot_flops_equal_the_reference(arch, kind, seq, remat):
    jshape, tshape = _shapes(kind, S=seq, B=4 if seq < 2048 else 2)
    mb = 2 if kind == "train" and seq < 2048 else 1
    jm, tm = _jmodel(arch), _tmodel(arch)
    cost = _tstep(tm, tshape, mb, remat)[0]
    assert int(cost["dot_flops"]) == _jstep(jm, jshape, mb, remat)
    assert _tprobes(tm, tshape, mb, remat) == _jprobes(jm, jshape, mb, remat)


@pytest.mark.parametrize("kind", KINDS)
def test_probe_is_one_layer(kind):
    _, shape = _shapes(kind)
    deep, one = _tmodel(FAMILIES[0], num_layers=3), _tmodel(FAMILIES[0],
                                                            num_layers=1)
    d = _tstep(deep, shape, 1, "nothing")[0]["dot_flops"]
    o = _tstep(one, shape, 1, "nothing")[0]["dot_flops"]
    (layer,) = [f for n, _, f in _tprobes(deep, shape, 1, "nothing")
                if n == "layer"]
    assert d - o == 2 * layer


# ------------------------------------------------------------------ (c)
@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_flops_near_the_compiled_reference(arch, kind):
    import jax
    import jax.numpy as jnp
    from repro.launch import hlo_stats as jstats
    from repro.launch import probes as jprobes
    from repro_torch.launch import hlo_stats, probes
    jshape, tshape = _shapes(kind, S=64)
    jm, tm = _jmodel(arch), _tmodel(arch)
    attn = "banded" if jm.cfg.window else "einsum"
    jp = jprobes.probes_for(jm, jshape, attn_impl=attn,
                            compute_dtype=jnp.float32)[0]
    want = jstats.cost_stats(jax.jit(jp.fn).lower(*jp.args).compile())
    with _fake():
        tp = probes.probes_for(tm, tshape, attn_impl=attn,
                               compute_dtype=torch.float32)[0]
        counter = hlo_stats.OpCounter()
        with counter:
            tp.fn(*tp.args)
    assert abs(counter.flops / want["flops"] - 1) < FLOPS_TOL


def test_bytes_and_elementwise_by_hand():
    from repro_torch.launch import hlo_stats
    x, y = torch.ones(6, 5), torch.ones(6, 5)
    counter = hlo_stats.OpCounter()
    with counter:
        z = (x + y) * y
        z.t().exp()
    n = 30 * 4
    assert counter.bytes == 3 * n + 3 * n + 2 * n    # add, mul, exp; t free
    assert counter.flops == 60 and counter.dot_flops == 0
    counter = hlo_stats.OpCounter()
    with counter:
        torch.ones(3, 4) @ torch.ones(4, 5)
    assert counter.dot_flops == 2 * 3 * 4 * 5 == counter.flops
    from repro.launch import hlo_stats as jstats
    for dtype, dims in (("bf16", "8,128"), ("f32", ""), ("s8", "3,5,7")):
        assert hlo_stats.shape_bytes(dtype, dims) == \
            jstats.shape_bytes(dtype, dims)


# ------------------------------------------------------------------ (d)
def test_collective_rule():
    from repro_torch.launch import hlo_stats
    got = hlo_stats.collective_bytes([("all-gather", 100, 4),
                                      ("reduce-scatter", 10, 4),
                                      ("all-reduce", 7, 2),
                                      ("all-gather", 1, 2),
                                      ("collective-permute", 5, 4)])
    assert got == {"all-gather": 101, "reduce-scatter": 40,
                   "all-reduce": 7, "collective-permute": 5, "total": 153}


def _fake_group(world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _zero3_collectives(monkeypatch, model, shape):
    """A ZeRO-3 train step of ``model`` on a fake (2, 2) mesh: its
    collective bytes by kind, and the all-gather and reduce-scatter bytes
    of ZeRO-3 worked out from the weights it reads. A leaf's gradient is
    summed over the batch's mesh dims and, the residual's rows being
    split over "model" (the dense decoder, S dividing 2), over "model"
    too where the rank does not keep the leaf's "model" block."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import spmd
    reads, regathers = [], []
    materialize, unpack = spmd.materialize, spmd._unpack

    def log_read(local, mesh, plan, dims):
        tp = mesh.mesh_dim_names.index("model")
        summed = tuple(dims) + ((tp,) if plan.tp_dim is None
                                and tp not in dims else ())
        reads.append((local.numel() * local.element_size(), plan.gathers,
                      summed, mesh))
        return materialize(local, mesh, plan, dims)

    def log_unpack(saved):
        if isinstance(saved, tuple) and saved[0] is spmd._GATHERED:
            local, mesh, gathers = saved[1]
            regathers.append((local.numel() * local.element_size(), gathers,
                              mesh))
        return unpack(saved)
    monkeypatch.setattr(spmd, "materialize", log_read)
    monkeypatch.setattr(spmd, "_unpack", log_unpack)
    _fake_group(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
        coll = _tstep(model, shape, 1, False, mesh)[2]
    finally:
        dist.destroy_process_group()
    gather, scatter = 0, 0
    for nbytes, gathers, dims, mesh in reads:
        size = nbytes
        for i, _ in gathers:            # forward: gathered dim by dim
            size *= mesh.size(i)
            gather += size
        for i, _ in reversed(gathers):  # backward: summed over the batch
            if i in dims:
                scatter += size
            size //= mesh.size(i)
    for nbytes, gathers, mesh in regathers:
        size = nbytes
        for i, _ in gathers:
            size *= mesh.size(i)
            gather += size
    assert reads and regathers
    return coll, gather, scatter


def _row_bytes(cfg, shape, heads_split):
    """The bytes per rank of the rows over "model" in a bf16 train step
    on a (2, 2) mesh, from the shapes: x, a (B / 2, S, D) activation of
    every row; kv, a K or V of every row. Forward: the vocab lookup's
    reduce-scatter; each layer's attention gathers x and reduce-scatters
    after wo with the heads split, else gathers K and V; each MLP
    gathers x and reduce-scatters after w_down; the vocab-split CE head
    gathers x, again when its checkpointed chunk reruns in the backward.
    Backward: each gather's gradient is reduce-scattered and each
    scatter's all-gathered."""
    L, b = cfg.num_layers, 2
    rows = shape.global_batch // 2 * shape.seq_len
    x, kv = rows * cfg.d_model * b, rows * cfg.num_kv_heads * cfg.head_dim * b
    attn_gather = x if heads_split else 2 * kv
    attn_scatter = x if heads_split else 0
    fwd_gather = L * (attn_gather + x) + x
    fwd_scatter = x + L * (attn_scatter + x)
    return {"all-gather": fwd_gather + x + fwd_scatter,
            "reduce-scatter": fwd_scatter + fwd_gather}


def _check_zero3(monkeypatch, over):
    model = _tmodel(FAMILIES[0], **over)
    cfg = model.cfg
    _, shape = _shapes("train", B=8)
    heads_split = cfg.num_heads % 2 == 0 and cfg.num_kv_heads % 2 == 0
    assert heads_split == bool(over)
    coll, gather, scatter = _zero3_collectives(monkeypatch, model, shape)
    rows = _row_bytes(cfg, shape, heads_split)
    assert coll["all-gather"] == gather + rows["all-gather"]
    assert coll["reduce-scatter"] == scatter + rows["reduce-scatter"]


def test_zero3_collectives_from_the_shardings(monkeypatch):
    """ZeRO-3's all-gather and reduce-scatter bytes, worked out from the
    reads, plus those of the rows over "model", worked out from the
    shapes; reduced qwen's one kv head keeps the heads whole
    (context-parallel attention)."""
    _check_zero3(monkeypatch, {})


def test_zero3_collectives_with_the_heads_over_model(monkeypatch):
    """The same with two kv heads, which put the heads over "model"
    (sequence parallelism: x gathered before attention, wo's sums
    reduce-scattered)."""
    _check_zero3(monkeypatch, {"num_kv_heads": 2})


# ------------------------------------------------------------------ (e)
def test_fake_memory_equals_the_real_run():
    from repro_torch.launch import dryrun
    model = _tmodel(FAMILIES[0])
    _, shape = _shapes("train")
    fake = _tstep(model, shape, 2, "nothing")[1]
    torch.manual_seed(0)
    step, args = dryrun.build_gate(model, shape, None, microbatches=2,
                                   compute_dtype=torch.float32)
    real = dryrun.count_step(step, args)[1]
    with _fake():
        step, args = dryrun.build_gate(model, shape, None, microbatches=2,
                                       compute_dtype=torch.float32)
        fake32 = dryrun.count_step(step, args)[1]
    assert real == fake32
    assert fake["argument_bytes"] == fake32["argument_bytes"]
    assert real["temp_bytes"] > 0 and real["code_bytes"] == 0


def test_argument_bytes_per_rank():
    import torch.distributed as dist
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.tree import tree_leaves
    model = _tmodel(FAMILIES[0])
    _, shape = _shapes("train", B=8)
    _fake_group(4)
    try:
        mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")
        with _fake():
            step, args = dryrun.build_gate(model, shape, mesh)
            mem = dryrun.count_step(step, args)[1]
            local = [t.to_local() for t in tree_leaves(args)]
    finally:
        dist.destroy_process_group()
    assert mem["argument_bytes"] == sum(t.numel() * t.element_size()
                                        for t in local)
    assert mem["alias_bytes"] == 0     # AdamW writes a new state


def test_budget_picks_the_first_microbatches_that_fit(monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import reduced_config
    real = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config",
                        lambda n: reduced_config(real(n)))
    monkeypatch.setattr(dryrun.configs, "get_shape",
                        lambda n: configs.ShapeConfig(n, 64, 8, "train"))

    def cell(budget):
        rec = dryrun.run_cell(FAMILIES[0], "t", mesh_shape=(2, 1),
                              hbm_budget_gib=budget / 2**30,
                              with_probes=False, verbose=False)
        return rec["microbatches"], dryrun.footprint(rec["gate"]["memory"])
    mb, one = cell(2**30)
    assert mb == 1
    # candidates dividing the data axis: 1, 2, 4 (8 / 8 rows would not)
    mb, two = cell(one - 1)
    assert mb == 2 and two <= one - 1
    mb, four = cell(two - 1)
    assert mb == 4 and four <= two - 1
    assert cell(1) == (4, four)         # none fits: the last candidate


def test_run_cell_refuses_an_existing_group():
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    _fake_group(2)
    try:
        with pytest.raises(RuntimeError, match="default one"):
            dryrun.run_cell(FAMILIES[0], "decode_32k", hbm_budget_gib=1)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ------------------------------------------------------------------ (f)
def test_configs_equal_the_reference():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    assert [(c.name, s.name, k) for c, s, k in tconfigs.cells(True)] == \
        [(c.name, s.name, k) for c, s, k in jconfigs.cells(True)]
    assert [(c.name, s.name) for c, s, _ in tconfigs.cells()] == \
        [(c.name, s.name) for c, s, _ in jconfigs.cells()]
    assert [dataclasses.astuple(s) for s in tconfigs.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jconfigs.ALL_SHAPES]
    for s in jconfigs.ALL_SHAPES:
        assert tconfigs.get_shape(s.name).tokens == s.tokens
    for name in jconfigs.list_archs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert (t.active_params(), t.total_params()) == \
            (j.active_params(), j.total_params())


@pytest.mark.parametrize("arch", FAMILIES)
def test_input_specs_equal_the_reference(arch):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    jm, tm = _jmodel(arch), _tmodel(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        want = jm.input_specs(jconfigs.get_shape(name))
        got = tm.input_specs(tconfigs.get_shape(name))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in got.items()}
        assert all(v.device.type == "meta" for v in got.values())


def test_record_keys_are_the_reference_keys(monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import reduced_config
    src = (REPO / "src/repro/launch/dryrun.py").read_text()
    body = src[src.index("def run_cell"):src.index("def save")]
    start = body.index("rec = {")
    literal = body[start:body.index("}", start)]
    keys = set(re.findall(r'"(\w+)":', literal))
    keys |= set(re.findall(r'rec\["(\w+)"\] =', body))
    gate = set(re.findall(r'rec\["gate"\]\["(\w+)"\]', body)) | set(
        re.findall(r'"(cost|memory|collectives)":', body))
    real = configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config",
                        lambda n: reduced_config(real(n)))
    monkeypatch.setattr(dryrun.configs, "get_shape",
                        lambda n: configs.ShapeConfig(n, 16, 4, "decode"))
    rec = dryrun.run_cell(FAMILIES[0], "t", mesh_shape=(2, 2),
                          hbm_budget_gib=1.0, verbose=False)
    assert set(rec) == keys | {"gate_is_whole_step"}
    assert rec["gate_is_whole_step"] is True
    assert set(rec["gate"]) == gate
    assert set(rec["probes"][0]) == {"name", "mult", "cost", "collectives",
                                     "compile_s"}


# ------------------------------------------------------------------ (g)
@pytest.mark.parametrize("arch", ["qwen2.5-32b", "dbrx-132b"])
def test_prefill_batch_chunks_equal_the_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch import steps
    jm, tm = _jmodel(arch), _tmodel(arch)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (4, 16))
    want = jsteps.make_prefill(jm, compute_dtype=jnp.float32,
                               attn_impl="einsum", batch_chunks=2)(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got = steps.make_prefill(tm, compute_dtype=torch.float32,
                             attn_impl="einsum", batch_chunks=2)(
        tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# serving cases on the gloo ranks: (name, arch, overrides); kv heads 2 put
# the dense decoder's heads over "model" at (1, 2), kv heads 1 its cache's
# sequence (the rank's block, read by flash decode)
SERVE_CASES = (("dense_tp", "qwen2.5-32b", {"num_kv_heads": 2}),
               ("dense_seq", "qwen2.5-32b", {}),
               ("moe", "dbrx-132b", {}), ("vlm", "llama-3.2-vision-11b", {}),
               ("encdec", "whisper-large-v3", {}), ("ssm", "rwkv6-7b", {}),
               ("hybrid", "hymba-1.5b", {}))
SERVE_MESHES = ((2, 1), (1, 2))


def _serve_batch(model, B=4, S=8):
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, model.cfg.vocab_size, (B, S)).astype(np.int32))}
    cfg = model.cfg
    if cfg.cross_attn_every:
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            0, 0.5, (B, cfg.num_image_tokens, cfg.d_model)).astype(
                np.float32))
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(rng.normal(
            0, 0.5, (B, 24, cfg.d_model)).astype(np.float32))
    return batch


def _serve_rank(arch, over, mesh_shapes):
    """{mesh: max |diff| of the sharded prefill (1 and 2 chunks) and of
    two lockstep decode steps (logits and every cache leaf) against
    mesh-free}."""
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.sharding import specs
    from repro_torch.tree import tree_map
    model = _tmodel(arch, **over)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _serve_batch(model)
    f32 = dict(compute_dtype=torch.float32)
    prefill = {(c, sh): steps.make_prefill(
        model, attn_impl="einsum", batch_chunks=c, scan_impl="scan",
        sharded=sh, **f32) for c in (1, 2) for sh in (False, True)}
    _, cache = steps.make_prefill(model, return_cache=True, s_max=16,
                                  scan_impl="scan", **f32)(params, batch)
    decode = {sh: steps.make_decode_step(model, scan_impl="scan", sharded=sh,
                                         **f32) for sh in (False, True)}
    extras = {k: v for k, v in batch.items() if k == "image_embeds"}
    toks = [torch.full((4, 1), t, dtype=torch.int32) for t in (3, 5)]

    def run_decode(p, c, place=lambda t, sh: t, shard=None):
        outs = []
        for tok in toks:
            b = dict(extras, token=tok)
            if shard is not None:
                b = place(b, shard(b))
            logits, c = decode[shard is not None](p, c, b)
            outs.append(logits)
        return outs, c

    ref = {c: prefill[c, False](params, batch) for c in (1, 2)}
    ref_dec, ref_cache = run_decode(params, tree_map(torch.clone, cache))
    out = {}
    for shape in mesh_shapes:
        mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
        with specs.use_mesh(mesh):
            p = steps.place(params, steps.param_shardings(model, params))
            b = steps.place(batch, steps.batch_shardings(model, batch))
            c = steps.place(tree_map(torch.clone, cache),
                            steps.cache_shardings(model, cache))
        err = max(float((prefill[n, True](p, b) - ref[n]).abs().max())
                  for n in (1, 2))
        with specs.use_mesh(mesh):
            got, c = run_decode(
                p, c, steps.place,
                lambda bb: steps.batch_shardings(model, bb))
        err = max([err] + [float((g - r).abs().max())
                           for g, r in zip(got, ref_dec)])
        for k, v in c.items():
            full = specs.full_tensor(v.to_local(), specs.sharding_of(v))
            err = max(err, float((full.float() - ref_cache[k].float()
                                  ).abs().max()))
        out[str(shape)] = err
    return out


def _rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {name: _serve_rank(arch, over, SERVE_MESHES)
           for name, arch, over in SERVE_CASES}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from test_torch_sharding import start_ranks, wait_ranks
    out_dir = tmp_path_factory.mktemp("dryrun_serving")
    return wait_ranks(start_ranks(2, out_dir, __file__), out_dir,
                      timeout=240)


@pytest.mark.parametrize("case", [c[0] for c in SERVE_CASES])
@pytest.mark.parametrize("shape", [str(s) for s in SERVE_MESHES])
def test_sharded_serving_steps_match_mesh_free(served, case, shape):
    for rank in served:
        assert rank[case][shape] < SERVE_TOL, (case, shape, rank[case])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
