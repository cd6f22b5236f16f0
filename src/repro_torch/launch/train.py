"""Training launcher of the port — a thin CLI over
:class:`repro_torch.api.Session`.

The reference's flags for the ``tensor``, ``pipeline``,
``swift_pipeline``, ``fedavg``, ``fl_pipeline``, ``hier_fl`` and
``distill_fl`` strategies, with its defaults (``--arch flad-vision
--strategy pipeline --mesh 2,4``: FHDP, the paper's system), plus
``--device`` (default ``cuda``; the mesh's ranks all run on that one
device). As the reference's, it keeps an edge backup every 10 steps,
writes a checkpoint every 50 when ``--checkpoint PATH`` is given, and
with ``--depart STEP:VID`` (``swift_pipeline`` only) departs vehicle VID
after step STEP, a live template switch. The async strategy and tracing
come with later slices.

  python -m repro_torch.launch.train --device cpu --steps 2
  python -m repro_torch.launch.train --device cpu \\
      --strategy swift_pipeline --mesh 2,2 --steps 2 --depart 0:0
  python -m repro_torch.launch.train --arch flad-vision --full \\
      --strategy pipeline --mesh 2,4 --steps 4
  python -m repro_torch.launch.train --arch flad-adllm --full \\
      --strategy hier_fl --topology 2@nano*2,agx*2 --codec int8 \\
      --local-steps 2 --steps 2 --shape 1024x4
  python -m repro_torch.launch.train --arch flad-adllm --full \\
      --strategy distill_fl --topology 2@nano*2,agx*2 --codec int8 \\
      --local-steps 2 --steps 2 --shape 1024x4 --lora-rank 4 \\
      --distill-warmup 2
"""
import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flad-vision")
    ap.add_argument("--shape", default=None, help="named shape or 'SEQxBATCH'")
    ap.add_argument("--strategy", default="pipeline",
                    choices=["tensor", "pipeline", "fedavg", "fl_pipeline",
                             "swift_pipeline", "hier_fl", "distill_fl"])
    ap.add_argument("--steps", type=int, default=50,
                    help="train steps (FL strategies: rounds)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--local-steps", type=int, default=1,
                    help="local steps per FL round (fedavg/fl_pipeline/"
                         "hier_fl/distill_fl)")
    ap.add_argument("--fleet", default="nano*4,agx*2",
                    help="heterogeneous fleet spec for swift_pipeline, "
                         "e.g. 'nano*4,nx*2,agx'")
    ap.add_argument("--topology", default="2@nano*2,agx*2",
                    help="vehicle->edge->cloud topology 'E@FLEET', e.g. "
                         "'2@nano*2,agx*2' = 2 edge pods over that fleet")
    ap.add_argument("--codec", default="none",
                    choices=["none", "int8", "topk"],
                    help="uplink codec (update compression)")
    ap.add_argument("--async-decay", type=float, default=None,
                    help="staleness decay per missed round deadline "
                         "(enables the predicted-staleness merge)")
    ap.add_argument("--lora-rank", type=int, default=4,
                    help="distill_fl: LoRA rank of the per-pod adapters")
    ap.add_argument("--kd-weight", type=float, default=0.3,
                    help="distill_fl: weight of the teacher-distillation "
                         "terms in the student loss")
    ap.add_argument("--mix", type=float, default=0.5,
                    help="distill_fl: per-round blend toward the cloud "
                         "merge (1 = global adapter, 0 = per-pod only)")
    ap.add_argument("--distill-warmup", type=int, default=20,
                    help="distill_fl: supervised warmup steps for the "
                         "frozen AD-LLM teacher")
    ap.add_argument("--depart", default=None, metavar="STEP:VID",
                    help="swift_pipeline: simulate vehicle VID departing "
                         "after step STEP (live template repartition)")
    ap.add_argument("--devices", type=int, default=0,
                    help="the reference forces N host devices; here N "
                         "below the mesh's size raises, as there")
    ap.add_argument("--mesh", default="2,4",
                    help="data,model (or pod,data,model)")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="write a checkpoint (.npz + .meta.json) to PATH "
                         "every 50 steps")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write a metrics-registry snapshot (JSON) to PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda runs the kernels; cpu their "
                         "plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.depart and args.strategy != "swift_pipeline":
        raise SystemExit("--depart requires --strategy swift_pipeline")
    from repro_torch.api import LoopHooks, MeshSpec, Session
    from repro_torch.recovery.backup import EdgeBackup
    mesh = MeshSpec.parse(args.mesh, devices=args.devices or None)
    options = {}
    fl = args.strategy in ("fedavg", "fl_pipeline", "hier_fl", "distill_fl")
    if fl:
        options["local_steps"] = args.local_steps
    if args.strategy == "fedavg":
        # the reference derives the clients from the mesh's FL axes
        options["clients"] = mesh.fl_clients
    if args.strategy == "swift_pipeline":
        options["fleet"] = args.fleet
    if args.strategy in ("hier_fl", "distill_fl"):
        options.update(topology=args.topology, codec=args.codec,
                       async_decay=args.async_decay)
    if args.strategy == "distill_fl":
        options.update(lora_rank=args.lora_rank, kd_weight=args.kd_weight,
                       mix=args.mix, warmup_steps=args.distill_warmup)
    session = Session(
        args.arch, full=args.full, shape=args.shape, mesh=mesh,
        strategy=args.strategy, learning_rate=args.lr, seed=args.seed,
        device=args.device,
        hooks=LoopHooks(log_every=1 if fl else 10,
                        backup=EdgeBackup(interval=10),
                        checkpoint_path=args.checkpoint,
                        checkpoint_every=50 if args.checkpoint else 0),
        **options)
    if args.depart:
        import dataclasses

        from repro_torch.recovery.recover import Repartitioner
        step_s, vid_s = args.depart.split(":")
        session.hooks = dataclasses.replace(
            session.hooks,
            repartition=Repartitioner(session, {int(step_s): int(vid_s)}))
    out = session.run(args.steps, metrics=args.metrics)
    last = out["history"][-1]
    print(f"[train] done: {last}")
    if args.metrics:
        print(f"[train] metrics snapshot written to {out['metrics_path']}")
    out["session"] = session
    return out


if __name__ == "__main__":
    main()
