"""Parse a jax.profiler xplane trace and print top ops by total device time.

Usage: python scripts/parse_trace.py /tmp/nmpc_trace [top_n]
"""
import collections
import glob
import sys

from jax.profiler import ProfileData


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/nmpc_trace"
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    paths = sorted(glob.glob(f"{root}/plugins/profile/*/*.xplane.pb"))
    if not paths:
        sys.exit(f"no xplane.pb under {root}")
    data = ProfileData.from_file(paths[-1])
    totals = collections.Counter()
    counts = collections.Counter()
    for plane in data.planes:
        # device planes: "/device:GPU:0" (kernels on the card's streams)
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                totals[(plane.name, line.name, ev.name)] += ev.duration_ns
                counts[(plane.name, line.name, ev.name)] += 1
    # aggregate per op name within device planes, skipping module-level lines
    agg = collections.Counter()
    aggc = collections.Counter()
    for (pl, ln, name), d in totals.items():
        if "XLA Modules" in ln or "Steps" in ln:
            continue
        agg[name] += d
        aggc[name] += counts[(pl, ln, name)]
    tot = sum(agg.values())
    print(f"planes: {[p.name for p in data.planes]}")
    print(f"total device op time: {tot/1e6:.2f} ms")
    for name, d in agg.most_common(top_n):
        print(f"{d/1e6:9.3f} ms  x{aggc[name]:<5d} {name[:120]}")


if __name__ == "__main__":
    main()
