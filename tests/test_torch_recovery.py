"""The port's recovery machinery (``repro_torch.recovery``, checkpoints,
the loop's hooks, ``swift_pipeline`` and the launcher) against the
reference on the CPU.

* Failures and modeled recovery: ``sample_failures`` equal event for
  event (numpy's generator, the same seed); ``recover`` and
  ``run_failure_sequence`` equal but for their timing fields (host
  clocks), for each strategy.
* Live repartitioning: ``swift_pipeline`` with a ``Repartitioner`` on
  reduced flad-vision on a (2, 2) mesh, with the fleet of the reference's
  own test (``tests/test_repartition.py``: the stable vehicle holds the
  whole model, and its departure forces another template), from the
  port's init bridged to the reference, on the same numpy batches. Held:
  the templates before and after, the restage bitwise
  (``params_identical``), the Adam step carried across it, and each
  step's loss within the FHDP step tests' tolerances
  (``tests/test_torch_pipeline.py``, ``tests/test_torch_trajectory.py``):
  relative 1e-5 at the first step, 1e-4 after (the near-eps params of the
  earlier steps move later losses by up to a few 1e-5 relative).
* Checkpoints cross between the packages both ways for a float32 stage
  container with equal sidecars; a bfloat16 leaf round-trips bitwise in
  the port, and a reference-written bfloat16 ``.npz`` (raw ``|V2``
  leaves) loads into the port bitwise.
* An ``EdgeBackup`` snapshot is a host copy that later steps cannot
  alias; the loop's thunk merges only on the steps that back up.
* The launcher parses ``--fleet``, ``--depart`` and ``--checkpoint`` and
  keeps the reference's default edge backup.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LoopHooks as JLoopHooks
from repro.api import Session as JSession
from repro.api.session import load_config as jax_load_config
from repro.config import ShapeConfig as JShape
from repro.recovery import failures as jfailures
from repro.recovery import recover as jrecover
from repro.recovery.recover import Repartitioner as JRepartitioner
from repro.sched import costmodel as jcost
from repro.train import checkpoint as jckpt
from repro_torch import bridge
from repro_torch.api import LoopHooks, Session
from repro_torch.api.session import load_config
from repro_torch.config import ShapeConfig
from repro_torch.core import pipeline as pl
from repro_torch.core.fhdp import init_fhdp
from repro_torch.recovery import failures, recover
from repro_torch.recovery.backup import EdgeBackup, restage
from repro_torch.recovery.recover import Repartitioner, fresh_zero2_opt
from repro_torch.sched import costmodel
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves, tree_map
from test_torch_pipeline import np_tree, numpy_batch, torch_batch

LR = 1e-3
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-4
BATCH, STEPS, DEPART_AFTER = 8, 3, 0
SILENT = dict(log_every=1, log_fn=lambda *a, **k: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rep_fleet(units):
    """The reference test's fleet (``tests/test_repartition.py:17-25``)."""
    u = units[0].cap
    return [dict(cmp=1e12, mem=2.5 * u, com=0.1e9, stb=0.9),
            dict(cmp=1e12, mem=1.2 * u, com=0.1e9, stb=0.7),
            dict(cmp=1e12, mem=1.2 * u, com=0.1e9, stb=0.6)]


def dwell_fleet():
    spec = [dict(cmp=c, mem=m, com=b, stb=s, dwl=d) for c, m, b, s, d in (
        (0.47e12, 8e9, 0.125e9, 0.9, 1800.0),
        (0.40e12, 8e9, 0.125e9, 0.8, 600.0),
        (3.85e12, 32e9, 0.25e9, 0.7, 2400.0),
        (0.47e12, 8e9, 0.125e9, 0.6, 900.0),
        (0.40e12, 8e9, 0.125e9, 0.5, 300.0))]
    return costmodel.parse_fleet(spec), jcost.parse_fleet(spec)


@pytest.mark.parametrize("seed", [0, 3])
def test_failures_and_modeled_recovery_match_reference(seed):
    vs, jvs = dwell_fleet()
    got = failures.sample_failures(vs, 3600.0, seed=seed,
                                   disconnect_rate=2.0)
    want = jfailures.sample_failures(jvs, 3600.0, seed=seed,
                                     disconnect_rate=2.0)
    assert [(e.time, e.vid, e.kind) for e in got] == \
        [(e.time, e.vid, e.kind) for e in want]
    cfg = load_config("flad-adllm", full=True)
    units = costmodel.model_units(cfg)
    junits = jcost.model_units(jax_load_config("flad-adllm", full=True))
    assert recover.REINIT_S == jrecover.REINIT_S
    from repro.recovery.templates import pregenerate as jpregenerate
    from repro_torch.recovery.templates import pregenerate
    ts, jts = pregenerate(vs, units), jpregenerate(jvs, junits)
    for strategy in ("template", "elastic", "relaunch"):
        for vid in range(len(vs)):
            a = recover.recover(strategy, ts, vid, vs, units)
            b = jrecover.recover(strategy, jts, vid, jvs, junits)
            assert (a.strategy, a.ok, a.moved_bytes) == \
                (b.strategy, b.ok, b.moved_bytes)
            assert (a.new_pipeline is None) == (b.new_pipeline is None)
            if a.new_pipeline is not None:
                assert a.new_pipeline.template() == b.new_pipeline.template()
                assert [v.vid for v in a.new_pipeline.path] == \
                    [v.vid for v in b.new_pipeline.path]
        a = recover.run_failure_sequence(vs, units, got, strategy)
        b = jrecover.run_failure_sequence(jvs, junits, want, strategy)
        timing = ("total_recovery_s", "mean_recovery_s")
        assert {k: v for k, v in a.items() if k not in timing} == \
            {k: v for k, v in b.items() if k not in timing}


# ------------------------------------------------------- live repartition
@pytest.fixture(scope="module")
def live_runs(mesh22, tmp_path_factory):
    """The departure run in both packages from the same start: (port
    session, its Repartitioner, port losses, reference session, its
    Repartitioner, reference losses, the batches, the checkpoint path)."""
    cfg, jcfg = load_config("flad-vision"), jax_load_config("flad-vision")
    fleet = rep_fleet(costmodel.model_units(cfg, seq_len=64,
                                            num_units=cfg.num_layers))
    ses = Session(cfg=cfg, strategy="swift_pipeline", mesh="2,2",
                  shape=ShapeConfig("rep", 16, BATCH, "train"),
                  learning_rate=LR, fleet=fleet, seq_len=64, device="cpu")
    tmpl = ses.strategy.resolve_templates(cfg, ses.mesh)
    pp, opt, _ = init_fhdp(cfg, ses.mesh, 0, templates=tmpl)
    batches = [numpy_batch(cfg, BATCH, 20 + i) for i in range(STEPS)]
    jses = JSession(cfg=jcfg, strategy="swift_pipeline", mesh=mesh22,
                    shape=JShape("rep", 16, BATCH, "train"),
                    learning_rate=LR, fleet=fleet, seq_len=64)
    jtmpl = jses.strategy.resolve_templates(jses.cfg, jses.mesh)
    jstate = (jax.tree.map(jnp.asarray, bridge.tree_to_numpy(pp)),
              jax.tree.map(jnp.asarray, bridge.zero2_to_numpy(opt, 2)))
    vid = jses.strategy.active_pipeline.path[0].vid
    jrep = JRepartitioner(jses, {DEPART_AFTER: vid}, log_fn=None)
    jout = jses.run(STEPS, state=jstate,
                    batches=[{k: jnp.asarray(v) for k, v in b.items()}
                             for b in batches],
                    hooks=JLoopHooks(repartition=jrep, **SILENT))
    ck = str(tmp_path_factory.mktemp("swift") / "ckpt")
    rep = Repartitioner(ses, {DEPART_AFTER: vid}, log_fn=None)
    backup = EdgeBackup(interval=2)
    out = ses.run(STEPS, state=(pp, opt),
                  batches=[torch_batch(b) for b in batches],
                  hooks=LoopHooks(repartition=rep, backup=backup,
                                  checkpoint_path=ck, checkpoint_every=1,
                                  **SILENT))
    assert {k: tuple(v) for k, v in tmpl.items()} == \
        {k: tuple(v) for k, v in jtmpl.items()}
    return dict(ses=ses, rep=rep, out=out, jses=jses, jrep=jrep, jout=jout,
                ck=ck, backup=backup, start=(pp, opt))


def test_live_repartition_matches_reference(live_runs):
    r = live_runs
    ses, jses = r["ses"], r["jses"]
    (ev,), (jev,) = r["rep"].events, r["jrep"].events
    assert ev.old_template == jev.old_template == {"blocks": (2, 0)}
    assert ev.new_template == jev.new_template == {"blocks": (1, 1)}
    assert (ev.step, ev.vid, ev.moved_bytes) == \
        (jev.step, jev.vid, jev.moved_bytes)
    assert ev.params_identical and jev.params_identical
    # the strategy committed the departure in both packages
    assert {k: tuple(v) for k, v in ses.strategy.templates.items()} == \
        ev.new_template
    assert [v.vid for v in ses.strategy.vehicles] == \
        [v.vid for v in jses.strategy.vehicles]
    assert ev.vid not in {v.vid for v in ses.strategy.vehicles}
    assert {k: (p.template() if p else None) for k, p in
            ses.strategy.template_set.on_departure.items()} == \
        {k: (p.template() if p else None) for k, p in
         jses.strategy.template_set.on_departure.items()}
    # the losses across the departure
    got = [h["loss"] for h in r["out"]["history"]]
    want = [h["loss"] for h in r["jout"]["history"]]
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        tol = FIRST_RTOL if i == 0 else LATER_RTOL
        assert abs(g - w) <= tol * abs(w), (i, got, want)
    # the bias correction went on from the carried step
    assert int(r["out"]["opt_state"]["step"]) == \
        int(r["jout"]["opt_state"]["step"]) == STEPS
    # the session keeps the swapped step and the final state's layout
    assert ses._built[0] is r["out"]["step_fn"]
    assert ses.state[0]["masks"]["blocks"].shape == (2, 1)


def test_fresh_zero2_opt_matches_reference(live_runs, mesh22):
    pp = live_runs["ses"].state[0]
    jpp = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(pp))
    for step in (None, 5):
        got = fresh_zero2_opt(pp, live_runs["ses"].mesh, step=None if step
                              is None else torch.tensor(step,
                                                        dtype=torch.int32))
        want = np_tree(jrecover.fresh_zero2_opt(jpp, mesh22, step=step))
        got = bridge.zero2_to_numpy(got, 2)
        assert int(got["step"]) == int(want["step"]) == (step or 0)
        for g, w in zip(jax.tree.leaves((got["m"], got["v"])),
                        jax.tree.leaves((want["m"], want["v"]))):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert not g.any()


def test_checkpoint_sidecar_tracks_the_switch(live_runs):
    r = live_runs
    meta = ckpt.load_meta(r["ck"])
    assert meta == jckpt.load_meta(r["ck"]) == {
        "arch": r["ses"].cfg.name, "strategy": "swift_pipeline",
        "templates": {"blocks": [1, 1]}}
    like = tree_map(lambda x: x.to("meta"), r["ses"].state[0])
    restored, step = ckpt.load(r["ck"], like)
    assert step == STEPS
    for a, b in zip(leaves(restored), leaves(r["ses"].state[0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the latest backup (step 2) restages under the balanced template
    snap = r["backup"].latest
    assert snap.step == 2 and r["backup"].backups_taken == 2
    cfg, mesh = r["ses"].cfg, r["ses"].mesh
    balanced = pl.make_templates(cfg, 2)
    back = pl.merge_stage_params(restage(snap.tree, cfg, balanced, mesh),
                                 balanced)
    for a, b in zip(leaves(back), leaves(snap.tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stage_checkpoints_cross_packages(writer, tmp_path):
    """A float32 stage container and its sidecar, written by one package
    and read by the other."""
    cfg = load_config("flad-vision")
    ses = Session(cfg=cfg, strategy="pipeline", mesh="2,2", device="cpu")
    pp, _, tmpl = init_fhdp(cfg, ses.mesh, 3)
    meta = {"strategy": "pipeline", "arch": cfg.name,
            "templates": {k: list(v) for k, v in tmpl.items()}}
    want = bridge.tree_to_numpy(pp)
    path = str(tmp_path / "stage")
    if writer == "port":
        ckpt.save(path, pp, step=7, meta=meta)
        jlike = jax.eval_shape(lambda: jax.tree.map(jnp.asarray, want))
        got, step = jckpt.load(path, jlike)
        got = np_tree(got)
    else:
        jckpt.save(path, jax.tree.map(jnp.asarray, want), step=7, meta=meta)
        got, step = ckpt.load(path, tree_map(lambda x: x.to("meta"), pp))
        got = bridge.tree_to_numpy(got)
    assert step == 7
    assert ckpt.load_meta(path) == jckpt.load_meta(path) == meta
    for (p, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                         jax.tree.leaves(got)):
        assert g.dtype == w.dtype and np.array_equal(g, w), p


def test_bfloat16_checkpoints(tmp_path):
    """bf16 round-trips bitwise in the port; a reference-written bf16
    ``.npz`` (raw |V2 leaves, which the reference's own load refuses)
    loads into the port bitwise."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=gen).to(torch.bfloat16),
            "b": {"x": torch.randn((3,), generator=gen)},
            "n": torch.arange(4, dtype=torch.int32)}
    path = str(tmp_path / "bf16")
    ckpt.save(path, tree, step=2)
    with np.load(path + ".npz") as data:
        assert data["w"].dtype == np.dtype("V2")
    got, step = ckpt.load(path, tree)
    assert step == 2
    for a, b in zip(leaves(got), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref_path = str(tmp_path / "ref_bf16")
    jtree = {"w": jnp.asarray(tree["w"].float().numpy(), jnp.bfloat16),
             "b": {"x": jnp.asarray(tree["b"]["x"].numpy())}}
    jckpt.save(ref_path, jtree, step=4)
    with np.load(ref_path + ".npz") as data:
        assert data["w"].dtype == np.dtype("V2")
    got, step = ckpt.load(ref_path, {"w": tree["w"], "b": tree["b"]})
    assert step == 4
    assert torch.equal(got["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    with pytest.raises(ValueError):
        jckpt.load(ref_path, jtree)
    with pytest.raises(KeyError, match="missing"):
        ckpt.load(path, {"q": tree["w"]})
    with pytest.raises(ValueError, match="!="):
        ckpt.load(path, {"w": tree["w"][:2]})
    bare = str(tmp_path / "bare")
    ckpt.save(bare, tree)
    assert ckpt.load_meta(bare) is None


def test_edge_backup_is_a_host_copy():
    live = {"a": torch.ones(4), "s": {"b": torch.zeros(2, 2)}}
    calls = []
    backup = EdgeBackup(interval=2)

    def view():
        calls.append(1)
        return live

    assert [backup.maybe_backup(i, view) for i in range(5)] == \
        [True, False, True, False, True]
    assert len(calls) == backup.backups_taken == 3
    assert len(backup.seconds) == 3
    snap = backup.latest.tree
    for x in leaves(live):
        x.add_(5.0)
    assert torch.equal(snap["a"], torch.ones(4))
    assert snap["a"].data_ptr() != live["a"].data_ptr()
    restored, step = backup.restore()
    restored["a"].add_(1.0)
    assert step == 4 and torch.equal(backup.latest.tree["a"], torch.ones(4))
    with pytest.raises(RuntimeError, match="no backup"):
        EdgeBackup().restore()


def test_session_backup_merges_only_on_backup_steps(monkeypatch):
    ses = Session("flad-vision", mesh="2,2", shape="1x8", device="cpu")
    merges = []
    real = ses.strategy.merge_params
    monkeypatch.setattr(ses.strategy, "merge_params",
                        lambda state, cfg=None: merges.append(1)
                        or real(state, cfg))
    backup = EdgeBackup(interval=3)
    seen = []
    out = ses.run(4, hooks=LoopHooks(backup=backup, on_step=lambda i, p, m:
                                     seen.append(i), **SILENT))
    assert len(merges) == backup.backups_taken == 2 and seen == [0, 1, 2, 3]
    # the snapshot (step index 3, the last) is the merged flat model,
    # held apart from the live params
    snap = backup.latest.tree
    final = ses.merged_params()
    for a, b in zip(leaves(snap), leaves(final)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    for live in leaves(ses.state[0]):
        assert all(live.data_ptr() != a.data_ptr() for a in leaves(snap))
    assert out["step_fn"] is ses._built[0]


def test_swift_pipeline_infeasible_fleet_raises():
    cfg = load_config("flad-vision")
    u = costmodel.model_units(cfg, seq_len=64, num_units=cfg.num_layers)[0]
    tiny = [dict(cmp=1e12, mem=0.5 * u.cap, com=0.1e9)] * 3
    ses = Session(cfg=cfg, strategy="swift_pipeline", mesh="2,2",
                  fleet=tiny, seq_len=64, device="cpu")
    with pytest.raises(ValueError, match="no pipeline"):
        ses.strategy.resolve_templates(ses.cfg, ses.mesh)
    with pytest.raises(RuntimeError, match="schedule"):
        Session(strategy="swift_pipeline", device="cpu") \
            .strategy.departure_template(0)


def test_launcher_swift_flags_and_default_backup(tmp_path):
    from repro_torch.launch.train import build_parser, main
    args = build_parser().parse_args([])
    assert args.fleet == "nano*4,agx*2" and args.depart is None \
        and args.checkpoint is None
    ck = str(tmp_path / "launch")
    out = main(["--device", "cpu", "--strategy", "swift_pipeline",
                "--mesh", "2,2", "--steps", "2", "--shape", "1x8",
                "--fleet", "nano*2,nx", "--depart", "0:0",
                "--checkpoint", ck])
    hooks = out["session"].hooks
    assert isinstance(hooks.backup, EdgeBackup) and \
        hooks.backup.interval == 10 and hooks.backup.backups_taken == 1
    assert hooks.checkpoint_path == ck and hooks.checkpoint_every == 50
    (ev,) = hooks.repartition.events
    assert ev.step == 0 and ev.vid == 0 and ev.params_identical
    assert [v.vid for v in out["session"].strategy.vehicles] == [1, 2]
    out = main(["--device", "cpu", "--mesh", "2,2", "--steps", "1",
                "--shape", "1x8"])
    assert out["session"].hooks.backup.backups_taken == 1
    with pytest.raises(SystemExit, match="requires --strategy "
                       "swift_pipeline"):
        main(["--device", "cpu", "--depart", "1:1"])


def test_checkpoint_meta_of_flat_strategies(tmp_path):
    ses = Session("flad-adllm", strategy="fedavg", clients=2, device="cpu",
                  shape="16x2")
    ses.build()
    assert ses._checkpoint_meta() == {"strategy": "fedavg",
                                      "arch": ses.cfg.name}
    path = str(tmp_path / "fed")
    ses.run(1, hooks=LoopHooks(checkpoint_path=path, checkpoint_every=1,
                               **SILENT))
    assert json.load(open(path + ".meta.json")) == ses._checkpoint_meta()
    restored, step = ckpt.load(path, tree_map(lambda x: x.to("meta"),
                                              ses.state[0]))
    assert step == 1
    for a, b in zip(leaves(restored), leaves(ses.state[0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="no stage templates"):
        ses.rebuild(templates={"blocks": (1, 1)})
