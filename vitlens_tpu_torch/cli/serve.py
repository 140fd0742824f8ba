"""Inference server CLI (port of vitlens_tpu/cli/serve.py): an HTTP encode
endpoint with cross-request micro-batching (see ``vitlens_tpu_torch/serve.py``).

  python -m vitlens_tpu_torch.cli.serve --modalities image text audio \
      --ckpt audio=/path/vitlensL_audio.pt --port 8000 \
      --batch-buckets 1 8 64 --max-batch 64 --max-wait-ms 5

Pair ``--batch-buckets`` with ``--max-batch`` equal to the top bucket, so
that coalesced batches land on warmed sizes. The model runs on the card
unless ``--device cpu`` is given. ``--data-parallel N`` serves a replica of
each tower on each of the first N cards (``cuda:0`` .. ``cuda:N-1``; with
``--device cpu``, N chunks on the host), every device batch split into N
contiguous chunks (``api.ViTLens(mesh=)``). SIGTERM or SIGINT drains the
admitted requests and exits 0.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vitlens inference server (PyTorch port)")
    p.add_argument("--model-var", default="vitlensL",
                   choices=["vitlensL", "vitlensB", "vitlensG"])
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="encode compute dtype (bf16 runs the hand-written "
                        "kernels; vitlensG also stores its weights in bf16)")
    p.add_argument("--modalities", nargs="+", default=["image", "text"],
                   help="towers to load: image, tactile, depth, audio, eeg, "
                        "video, pc, text (items: image/tactile paths, depth "
                        ".npy/.png/.pt, WAV/FLAC, EEG .pt, video frame "
                        "directories, .npy clouds or numeric items, captions)")
    p.add_argument("--ckpt", action="append", default=[],
                   help="modality=path (repeatable); use all=path for merged")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=64,
                   help="coalesce concurrent requests up to this many items "
                        "per device dispatch")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long a request waits for co-batching company; "
                        "keep small at low load, raise to about the batch "
                        "latency at saturation so batches fill before "
                        "padding")
    p.add_argument("--batch-buckets", type=int, nargs="*", default=None,
                   help="pad device batches to these sizes; default: powers "
                        "of 2 up to --max-batch, so every coalesced batch "
                        "lands on a warmed size")
    p.add_argument("--data-parallel", type=int, default=0, metavar="N",
                   help="split device batches over the first N cards, a "
                        "replica of each tower on each (0 = one device)")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="per-request default timeout in seconds; without "
                        "warmup it must cover the first call's kernel build")
    p.add_argument("--queue-capacity", type=int, default=None,
                   help="max pending items before requests shed with 503 "
                        "(default 4x max-batch)")
    p.add_argument("--no-pipeline", dest="pipeline", action="store_false",
                   help="serialize host preprocessing and device compute in "
                        "one thread instead of overlapping them")
    p.add_argument("--no-warmup", dest="warmup", action="store_false",
                   help="skip the startup run of every (modality, batch "
                        "bucket) encode (on by default: without it the first "
                        "request of each size pays the kernel build and "
                        "first-call set-up)")
    return p


def default_buckets(max_batch: int) -> list:
    """Powers of 2 up to max_batch (inclusive): every coalesced batch size
    pads onto a warmed size (rows are computed independently)."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_batch))
    return buckets


def data_parallel_mesh(n: int, device=None):
    """The local mesh of ``--data-parallel n`` (None for 0): the first n
    CUDA devices, or n chunks on the CPU when ``device`` is the CPU."""
    if not n:
        return None
    import torch

    from vitlens_tpu_torch.parallel.mesh import make_mesh

    if device is not None and torch.device(device).type == "cpu":
        return make_mesh(devices=["cpu"] * n)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        raise RuntimeError(f"--data-parallel {n}: {count} CUDA device(s) "
                           "visible (pass --device cpu for the host)")
    return make_mesh(devices=[f"cuda:{i}" for i in range(n)])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mesh = data_parallel_mesh(args.data_parallel, args.device)

    ckpts = {}
    for spec in args.ckpt:
        k, _, v = spec.partition("=")
        ckpts[k] = v

    import torch

    from vitlens_tpu_torch.api import ViTLens
    from vitlens_tpu_torch.serve import make_server

    buckets = args.batch_buckets
    if buckets is None:
        buckets = default_buckets(args.max_batch)
    elif max(buckets) < args.max_batch:
        print(f"warning: max(batch-buckets)={max(buckets)} < --max-batch "
              f"{args.max_batch}: coalesced batches above the top bucket run "
              f"at sizes warmup did not run", flush=True)

    bf16 = args.precision == "bf16"
    model = ViTLens(model_var=args.model_var,
                    modality_loaded=list(args.modalities), checkpoints=ckpts,
                    device=None if mesh else args.device, mesh=mesh,
                    batch_buckets=buckets,
                    compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                    param_dtype=(torch.bfloat16
                                 if bf16 and args.model_var == "vitlensG"
                                 else None))
    if args.warmup:
        print("warming up (one encode per modality x batch bucket)...",
              flush=True)
        model.warmup(log=lambda s: print(f"  {s}", flush=True))
    srv = make_server(model, host=args.host, port=args.port,
                      max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                      queue_capacity=args.queue_capacity,
                      default_timeout_s=args.request_timeout,
                      pipeline=args.pipeline)
    host, port = srv.server_address[:2]
    print(f"vitlens-serve listening on http://{host}:{port} "
          f"(modalities={args.modalities}, device={model.device})", flush=True)

    # Graceful drain on SIGTERM/SIGINT: stop accepting new HTTP work, then
    # encoder.close() drains; its sentinel lands behind the admitted
    # requests (FIFO), so everything accepted before the signal is answered
    # before exit 0. shutdown() runs off the main thread: the handler
    # interrupts serve_forever() itself, and a same-thread shutdown() would
    # wait for the suspended poll loop forever.
    import signal
    import threading

    def _graceful(signum, frame):
        print(f"vitlens-serve: signal {signum}, draining...", flush=True)
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.encoder.close()  # FIFO drain of admitted requests, no time cap
        srv.server_close()
        with srv.encoder._lock:
            stats = dict(srv.encoder.stats)
        print(f"vitlens-serve: drained, exiting (served "
              f"{stats.get('items', 0)} items in "
              f"{stats.get('batches', 0)} batches)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
