"""The port's logical-axis sharding (``repro_torch.sharding.specs``) against
``repro.sharding.specs``: the rule tables equal, the resolution of every
logical axis equal with no mesh, and on a 2-axis (data=2, model=2) mesh of
4 gloo ranks under each rule table the same as the reference's resolution
on a mesh of the same axes (the reference's single-process resolution and
nesting cases, ``tests/test_distributed.py``); ``head_shard_axis`` and
``latent_head_shard_axis`` on divisible and indivisible head counts on a
4-rank "model" mesh; ``head_slab``, ``replicate`` and ``replicate_params``
per rank; ``launch.mesh``. The ranks are one spawn of this file run as a
script (torch only, one thread each, a file store, a timeout); the test
process compares what they report. ``shard`` / ``spec_tree`` /
``shardings_for`` (the training half) are held in
``tests/test_torch_sharded_train.py``."""
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 120

# (rules table name, logical axes) resolved on the 2-axis mesh
RESOLVE_CASES = [
    ("DEFAULT_RULES", ("batch", "heads")),
    ("DEFAULT_RULES", ("batch", "seq_sp", "kv_heads", None)),
    ("DEFAULT_RULES", ("fsdp", "d_ff", "vocab", "expert")),
    ("DEFAULT_RULES", ("kv_seq", "stage", ("data", "model"))),
    ("PIPELINE_RULES", ("batch", "stage", "fsdp")),
    ("SERVE_RULES", ("fsdp", "heads", "batch")),
    ("TP_SERVE_RULES", ("heads", "d_ff", "batch", "kv_heads")),
    ("TP_POOL_RULES", ("kv_heads", "heads", "batch")),
]
# every logical axis of the default table, sized under each table
LOGICAL = ("batch", "seq_sp", "heads", "kv_heads", "d_ff", "vocab", "expert",
           "fsdp", "kv_seq", "stage")
FIT_CASES = [((8, 12), ("batch", "heads")), ((8, 10), ("batch", "heads")),
             ((3, 12), ("batch", "heads")), ((2, 8, 16, 4, 8), "KV_POOL"),
             ((2, 8, 16, 5, 8), "KV_POOL")]
HEAD_CASES = [(8, 4), (8, 2), (6, 4), (40, 8), (12, 12), (4, 1)]
LATENT_CASES = [8, 40, 6, 2]


def _rules(specs, name):
    return getattr(specs, name)


def _fit_axes_of(specs, axes):
    return specs.KV_POOL_AXES if axes == "KV_POOL" else axes


# ------------------------------------------------------------- the ranks
def _rank_main(rank: int, world: int, out_dir: str):
    """One rank: the 2-axis mesh's resolutions, the tp helpers on a 4-rank
    "model" mesh, results to rank<r>.json."""
    import torch.distributed as dist
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import specs
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    out = {"resolve": [], "axis_size": {}, "fit": [], "head": [],
           "latent": []}
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out["describe"] = mesh_mod.describe(mesh)
    assert specs.active_mesh() is None
    for name, axes in RESOLVE_CASES:
        with specs.use_mesh(mesh, _rules(specs, name)):
            out["resolve"].append(list(specs.resolve(*axes)))
    for name in ("DEFAULT_RULES", "TP_POOL_RULES", "TP_SERVE_RULES"):
        with specs.use_mesh(mesh, _rules(specs, name)):
            out["axis_size"][name] = [specs.axis_size(a) for a in LOGICAL]
    with specs.use_mesh(mesh):
        for shape, axes in FIT_CASES:
            out["fit"].append(list(specs._fit_axes(
                shape, _fit_axes_of(specs, axes))))
    # nesting: the inner mesh and rules win inside, the outer comes back
    tp_mesh = specs.serve_mesh(world, "cpu")
    with specs.use_mesh(mesh, specs.DEFAULT_RULES):
        with specs.use_mesh(tp_mesh, specs.TP_SERVE_RULES):
            inner = (specs.active_mesh() is tp_mesh,
                     list(specs.resolve("heads", "d_ff")))
        outer = (specs.active_mesh() is mesh, specs.resolve("batch")[0])
    out["nesting"] = [inner[0], inner[1], outer[0], outer[1],
                      specs.active_mesh() is None]
    with specs.use_mesh(tp_mesh, specs.TP_SERVE_RULES):
        for H, KV in HEAD_CASES:
            m, ax = specs.head_shard_axis(H, KV)
            out["head"].append([m is tp_mesh, ax])
        for H in LATENT_CASES:
            m, ax = specs.latent_head_shard_axis(H)
            out["latent"].append([m is tp_mesh, ax])
        sl = specs.head_slab(40, tp_mesh)
        out["slab"] = [sl.start, sl.stop]
        x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3) + 10 * rank
        out["replicate"] = specs.replicate(x).tolist()
    out["replicate_no_mesh"] = specs.replicate(torch.ones(2)).tolist()
    out["head_no_mesh"] = list(specs.head_shard_axis(8, 4))
    params = {"w": torch.full((3,), float(rank)),
              "b": [torch.full((2,), float(rank + 1))]}
    specs.replicate_params(params, tp_mesh)
    out["params"] = [params["w"].tolist(), params["b"][0].tolist()]
    # a (2, 2) world of tp=2 groups: ranks 0-1 and 2-3
    pair = specs.serve_mesh(2, "cpu")
    with specs.use_mesh(pair, specs.TP_SERVE_RULES):
        out["pair"] = specs.replicate(torch.tensor([float(rank)])).tolist()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def start_ranks(world: int, out_dir: pathlib.Path, script: str) -> list:
    """Start ``script`` (a test file with a ``_rank_main``) as ``world``
    rank processes; :func:`wait_ranks` collects them."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def wait_ranks(procs: list, out_dir: pathlib.Path,
               timeout: float = TIMEOUT) -> list:
    """Wait for the ranks; one that fails, or a run past ``timeout``
    (counted from now), kills every rank and fails. Returns each rank's
    JSON."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(procs)} ranks still running "
                                   f"after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(
        log[-3000:] for log in logs)
    return [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sharding")
    return wait_ranks(start_ranks(WORLD, out_dir, __file__), out_dir)


class _Mesh:
    """A stand-in mesh for the reference's resolution: its helpers read
    only ``axis_names`` and ``shape``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class _TorchMesh:
    """The same for the port's, which reads a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", ["DEFAULT_RULES", "PIPELINE_RULES",
                                  "SERVE_RULES", "TP_SERVE_RULES",
                                  "TP_POOL_RULES", "KV_POOL_AXES",
                                  "TP_AXIS"])
def test_rule_tables_equal_the_reference(name):
    from repro.sharding import specs as jspecs
    from repro_torch.sharding import specs
    assert getattr(specs, name) == getattr(jspecs, name)


def test_resolution_without_a_mesh_is_identity():
    from repro.sharding import specs as jspecs
    from repro_torch.sharding import specs
    assert specs.active_mesh() is None
    assert specs.resolve(*LOGICAL, None) == tuple(jspecs.resolve(*LOGICAL,
                                                                 None))
    assert [specs.axis_size(a) for a in LOGICAL] == \
        [jspecs.axis_size(a) for a in LOGICAL] == [1] * len(LOGICAL)
    assert specs._fit_axes((8, 12), ("batch", "heads")) == (None, None)
    assert specs.head_shard_axis(8, 4) == (None, None)
    assert specs.latent_head_shard_axis(8) == (None, None)
    x = torch.ones(3)
    assert specs.replicate(x) is x
    assert specs.replicate_params(x, None) is x
    assert specs.serve_trace(None, len) is len


def test_use_mesh_nesting_restores_outer():
    """The reference's nesting case with stand-in meshes: the inner mesh
    and rules win inside, the outer (or none) comes back on exit."""
    from repro_torch.sharding import specs
    outer, inner = _TorchMesh((1,), ("data",)), _TorchMesh((1,), ("model",))
    with specs.use_mesh(outer, specs.DEFAULT_RULES):
        assert specs.active_mesh() is outer
        with specs.use_mesh(inner, specs.TP_SERVE_RULES):
            assert specs.active_mesh() is inner
            assert specs.resolve("heads", "d_ff") == (None, None)
        assert specs.active_mesh() is outer
        assert specs.resolve("batch")[0] == "data"
        assert specs.resolve("batch", "heads")[1] is None   # no 'model'
    assert specs.active_mesh() is None


@pytest.mark.parametrize("case", range(len(RESOLVE_CASES)))
def test_resolve_on_a_2x2_mesh_equals_the_reference(ranks, case):
    from repro.sharding import specs as jspecs
    name, axes = RESOLVE_CASES[case]
    with jspecs.use_mesh(_Mesh((2, 2), ("data", "model")),
                         _rules(jspecs, name)):
        want = [list(a) if isinstance(a, tuple) else a
                for a in jspecs.resolve(*axes)]
    for r in ranks:
        got = [list(a) if isinstance(a, list) else a
               for a in r["resolve"][case]]
        assert got == want, (name, axes)


@pytest.mark.parametrize("name", ["DEFAULT_RULES", "TP_POOL_RULES",
                                  "TP_SERVE_RULES"])
def test_axis_size_on_a_2x2_mesh_equals_the_reference(ranks, name):
    from repro.sharding import specs as jspecs
    with jspecs.use_mesh(_Mesh((2, 2), ("data", "model")),
                         _rules(jspecs, name)):
        want = [jspecs.axis_size(a) for a in LOGICAL]
    assert all(r["axis_size"][name] == want for r in ranks)


@pytest.mark.parametrize("case", range(len(FIT_CASES)))
def test_fit_axes_on_a_2x2_mesh_equals_the_reference(ranks, case):
    from repro.sharding import specs as jspecs
    shape, axes = FIT_CASES[case]
    with jspecs.use_mesh(_Mesh((2, 2), ("data", "model"))):
        want = list(jspecs._fit_axes(shape, _fit_axes_of(jspecs, axes)))
    assert all(r["fit"][case] == want for r in ranks)


def test_nesting_on_real_meshes(ranks):
    for r in ranks:
        assert r["nesting"] == [True, [None, None], True, "data", True]
        assert r["describe"] == "mesh{'data': 2, 'model': 2} (4 devices)"


@pytest.mark.parametrize("case", range(len(HEAD_CASES)))
def test_head_shard_axis_equals_the_reference(ranks, case):
    """Resolves only where tp = 4 divides both head counts."""
    from repro.sharding import specs as jspecs
    with jspecs.use_mesh(_Mesh((WORLD,), ("model",)), jspecs.TP_SERVE_RULES):
        m, ax = jspecs.head_shard_axis(*HEAD_CASES[case])
    assert all(r["head"][case] == [m is not None, ax] for r in ranks)
    assert all(r["head_no_mesh"] == [None, None] for r in ranks)


@pytest.mark.parametrize("case", range(len(LATENT_CASES)))
def test_latent_head_shard_axis_equals_the_reference(ranks, case):
    from repro.sharding import specs as jspecs
    with jspecs.use_mesh(_Mesh((WORLD,), ("model",)), jspecs.TP_SERVE_RULES):
        m, ax = jspecs.latent_head_shard_axis(LATENT_CASES[case])
    assert all(r["latent"][case] == [m is not None, ax] for r in ranks)


def test_head_slab_replicate_and_params_per_rank(ranks):
    """Rank r holds heads 10 r .. 10 r + 9 of 40; ``replicate`` gathers the
    ranks' tensors on the last axis in rank order; ``replicate_params``
    leaves every rank with the first rank's weights; a world of 4 at tp = 2
    gathers within ranks 0-1 and 2-3."""
    want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
                      + 10 * r for r in range(WORLD)], dim=-1).tolist()
    for rank, r in enumerate(ranks):
        assert r["slab"] == [10 * rank, 10 * rank + 10]
        assert r["replicate"] == want
        assert r["replicate_no_mesh"] == [1.0, 1.0]
        assert r["params"] == [[0.0] * 3, [1.0] * 2]
        base = rank // 2 * 2
        assert r["pair"] == [float(base), float(base + 1)]


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
