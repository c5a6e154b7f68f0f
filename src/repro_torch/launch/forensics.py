"""Buffer forensics: what dominates a dry-run cell's peak memory.

    python -m repro_torch.launch.forensics --arch whisper-base \
        --shape decode_32k [--layers 2] [--min-mb 100]

Prints the largest tensors alive on a rank at its peak, grouped by local
shape and dtype, with the op that made each: the port's "profile" of
the dry-run world (no wall-clock trace), as the reference's HLO buffer
forensics are.
"""
from __future__ import annotations

import argparse
import collections


def big_buffers(peak_buffers, min_bytes: float = 100e6, top: int = 24):
    """Group the live storages at the peak (``lower_cell(...,
    keep_buffers=...)["peak_buffers"]``: (bytes, local shape, dtype, op)
    each) by local shape and dtype, largest first: count, GiB each, the
    op that made the first."""
    agg = collections.Counter()
    example = {}
    for nbytes, shape, dtype, op in peak_buffers:
        if nbytes < min_bytes:
            continue
        key = f"{dtype.replace('torch.', '')}{list(shape)}"
        agg[key] += 1
        example.setdefault(key, (nbytes, op))
    rows = []
    for key, cnt in sorted(agg.items(),
                           key=lambda kv: -example[kv[0]][0] * kv[1])[:top]:
        nbytes, op = example[key]
        rows.append({"shape": key, "count": cnt, "gib": nbytes / 2**30,
                     "op": op})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--min-mb", type=float, default=100.0)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import lower_cell
    min_bytes = args.min_mb * 2**20
    res = lower_cell(args.arch, args.shape, args.multi_pod,
                     n_layers=args.layers, keep_buffers=min_bytes)
    m = res["memory"]
    print(f"peak={m['peak_bytes_per_device']/2**30:.2f} GiB  "
          f"arg={m['argument_bytes']/2**30:.2f} out="
          f"{m['output_bytes']/2**30:.2f} temp={m['temp_bytes']/2**30:.2f} "
          f"alias={m['alias_bytes']/2**30:.2f}")
    rows = big_buffers(res["peak_buffers"], min_bytes)
    for r in rows:
        print(f"x{r['count']:3d} {r['gib']:7.2f}GiB {r['shape'][:44]:46s} "
              f"op={r['op'][:24]}")
    return rows


if __name__ == "__main__":
    main()
