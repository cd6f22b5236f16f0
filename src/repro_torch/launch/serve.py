"""Serving launcher of the port — a thin CLI over
:meth:`repro_torch.api.Session.serve`, on the card by default.

The reference's flags and defaults, plus ``--device`` (default
``cuda``). Both schedulers go through ``Session.serve``: ``--scheduler
legacy`` (the default, as the reference's) is the static-batch loop
(``--batch`` prompts of ``--context`` tokens, ``--decode-steps`` decode
steps, ``--requests`` batches), ``--scheduler continuous`` the paged
continuous-batching tier, with draft-verify speculative decoding under
``--speculative`` (``--draft-k`` drafts a lane a step, self-drafting),
and ``--trace PATH`` writes the final warm pass's sim-time trace
(continuous only, as the reference's).

  python -m repro_torch.launch.serve --arch xlstm-350m --full \\
      --batch 8 --context 512 --decode-steps 32
  python -m repro_torch.launch.serve --arch flad-adllm --full \\
      --scheduler continuous --slots 8 --block-size 16 --cache int8 \\
      --speculative --draft-k 4
  python -m repro_torch.launch.serve --device cpu --scheduler continuous \\
      --requests 3 --trace serve_trace.json
  python -m repro_torch.launch.serve --arch qwen3-14b --full \\
      --scheduler continuous --slots 8 --block-size 16 --cache int8
  python -m repro_torch.launch.serve --arch hymba-1.5b --full \\
      --batch 8 --context 512 --decode-steps 32
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --full --batch 8 --context 512 --decode-steps 32

``--arch`` takes every registered config (``repro_torch.configs
.ARCH_IDS``); the continuous scheduler serves the dense ones (flad-adllm,
qwen2.5-32b, qwen3-14b, qwen3-32b, yi-34b), the legacy one every decoder
(xlstm-350m and hymba-1.5b too) and the encoder-decoder
(seamless-m4t-large-v2: each request ``--context`` frames beside its
``--context`` prompt tokens).
"""
import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flad-adllm",
                    help="a registered config (repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=64,
                    help="prompt tokens (legacy) / monolithic prefill "
                         "bucket, max_context (continuous)")
    ap.add_argument("--decode-steps", type=int, default=16,
                    help="decode steps per batch (legacy scheduler)")
    ap.add_argument("--requests", type=int, default=3,
                    help="request batches (legacy) / trace length "
                         "(continuous)")
    ap.add_argument("--scheduler", choices=("legacy", "continuous"),
                    default="legacy")
    ap.add_argument("--slots", type=int, default=0,
                    help="continuous-batching lanes (default: --batch)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="KV block size in tokens")
    ap.add_argument("--cache", choices=("fp32", "int8"), default="fp32",
                    help="paged KV-cache storage mode (fp32 = the model's "
                         "dtype)")
    ap.add_argument("--prefill", choices=("chunked", "monolithic"),
                    default="chunked",
                    help="prompt prefill path: paged chunks interleaved "
                         "with decode, or the bucketed monolithic baseline")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="tokens per prefill chunk (chunked)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share pod prompt-prefix KV blocks across "
                         "requests (chunked prefill only)")
    ap.add_argument("--fleet", default="nano*2,agx*2",
                    help="vehicle fleet spec for the load generator")
    ap.add_argument("--speculative", action="store_true",
                    help="draft-verify speculative decoding (continuous, "
                         "greedy; float32 streams stay bitwise those of "
                         "plain decode)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per lane per step "
                         "(with --speculative)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto-loadable sim-time trace of "
                         "the final warm pass to PATH (continuous)")
    ap.add_argument("--sampling", choices=("greedy", "temperature"),
                    default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: its reduced "
                         "smoke variant, as the reference's Session)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.api import Session

    session = Session(args.arch, full=args.full, seed=args.seed,
                      device=args.device)
    kw = {}
    if args.scheduler == "continuous":
        kw = dict(block_size=args.block_size, cache=args.cache,
                  fleet=args.fleet, prefill=args.prefill,
                  prefill_chunk=args.prefill_chunk,
                  prefix_cache=args.prefix_cache, trace=args.trace,
                  speculative=args.speculative)
        if args.speculative:
            kw["draft_k"] = args.draft_k
    elif args.trace:
        raise SystemExit("--trace requires --scheduler continuous")
    elif args.speculative:
        raise SystemExit("--speculative requires --scheduler continuous")
    report = session.serve(requests=args.requests,
                           batch=args.slots or args.batch,
                           context=args.context,
                           decode_steps=args.decode_steps,
                           scheduler=args.scheduler, sampling=args.sampling,
                           temperature=args.temperature, **kw)
    if args.trace:
        print(f"[serve] trace written to {report['trace_path']} "
              f"(load at https://ui.perfetto.dev)")
    return report


if __name__ == "__main__":
    main()
