"""Serving launcher of the port: the continuous-batching tier on the card.

The same flags as ``repro/launch/serve.py``'s continuous scheduler, plus
``--device`` (default ``cuda``). It calls
:func:`repro_torch.serve.serve_continuous` directly: ``Session.serve``
comes with the slice that ports ``Session.run``. The legacy static-batch
scheduler, speculative decoding and tracing are later slices and raise.

  python -m repro_torch.launch.serve --arch flad-adllm --full \\
      --slots 8 --block-size 16 --cache int8 --fleet nano*2,agx*2
"""
import argparse

_LATER = {
    "legacy": "the legacy static-batch scheduler comes with a later slice "
              "of the port (it runs no kernel of this one)",
    "speculative": "--speculative comes with the speculative-decoding "
                   "slice of the port",
    "trace": "--trace comes with the observability slice of the port",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="flad-adllm")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--context", type=int, default=64,
                    help="monolithic prefill bucket (max_context)")
    ap.add_argument("--requests", type=int, default=3,
                    help="trace length")
    ap.add_argument("--scheduler", choices=("legacy", "continuous"),
                    default="continuous")
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
                    help="draft-verify speculative decoding (later slice)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="sim-time trace of the final warm pass (later "
                         "slice)")
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

    if args.scheduler == "legacy":
        raise NotImplementedError(_LATER["legacy"])
    if args.speculative:
        raise NotImplementedError(_LATER["speculative"])
    if args.trace:
        raise NotImplementedError(_LATER["trace"])

    from repro_torch.configs import get_config, reduced
    from repro_torch.serve import serve_continuous

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    return serve_continuous(
        cfg, seed=args.seed, slots=args.slots or args.batch,
        block_size=args.block_size, max_context=args.context,
        cache=args.cache, prefill=args.prefill,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        sampling=args.sampling, temperature=args.temperature,
        fleet=args.fleet, num_requests=args.requests, device=args.device)


if __name__ == "__main__":
    main()
