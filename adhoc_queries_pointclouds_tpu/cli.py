"""Command-line surface — replicates the reference `query` CLI
(query/src/main.rs:194-220) and adds `convert` / `count-points` subcommands
(capabilities the reference outsources to sibling projects).

Flag parity with the reference binary:
  -i/--input    file or directory (non-recursive) of las/laz/last/lazer
  --bounds      "minx;miny;minz;maxx;maxy;maxz" world-space closed box
  --class       u8 classification value (mutually exclusive with --bounds)
  --density     max density: <= 1 point per X^3 m^3 grid-center sampling
  -o/--output   output directory -> matching points written as LAS
  --parallel    accepted for parity; the engine always data-parallelizes
                across the device mesh (rayon's role is played by the mesh)
  --optimized   accepted for parity; there is only one engine path and it is
                the optimized one (integer-domain predicates on device)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .engine import run_query
from .models.query import (
    BoundsQuery,
    ClassQuery,
    DensityConfig,
    QueryPlan,
    TimeRangeQuery,
)
from .utils.aabb import parse_aabb
from .utils.timing import throughput_line


def build_query_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-i", "--input", required=True, help="Input point cloud file or directory")
    parser.add_argument("--bounds", help='Bounding box "minX;minY;minZ;maxX;maxY;maxZ"')
    parser.add_argument("--class", dest="classification", type=int, help="LAS object class (u8)")
    parser.add_argument(
        "--time-range", dest="time_range",
        help='GPS-time half-open range "start;end" (working version of the '
             "reference's dead time-query stubs)",
    )
    parser.add_argument("-o", "--output", help="Output directory for matching points (LAS)")
    parser.add_argument("--density", type=float, help="Maximum density: one point per X^3 m^3")
    parser.add_argument(
        "--density-scope",
        choices=["file", "global"],
        default="global",
        help="Dedupe grid per input file (reference --parallel semantics) or globally",
    )
    parser.add_argument("--parallel", action="store_true", help="(parity no-op: always parallel)")
    parser.add_argument("--optimized", action="store_true", help="(parity no-op: always optimized)")
    parser.add_argument(
        "--print-points", action="store_true",
        help="Print each matching point (reference StdOutCollector)",
    )
    parser.add_argument("--parity-quirk", action="store_true",
                        help="Replicate the reference's exact world->local bounds conversion")
    parser.add_argument("--block-size", type=int, default=None, help="Points per device block")
    parser.add_argument("--devices", type=int, default=None, help="Limit device count")
    parser.add_argument("--workers", type=int, default=8, help="Host decode threads")
    parser.add_argument("--stats", action="store_true", help="Print per-stage timings")
    parser.add_argument(
        "--keep-going", action="store_true",
        help="Skip unreadable files instead of aborting (reference aborts)",
    )
    parser.add_argument(
        "--no-index", action="store_true",
        help="Ignore block min/max sidecar indexes (pure brute-force scan)",
    )
    parser.add_argument(
        "--profile", metavar="DIR",
        help="Capture a jax.profiler trace of the query into DIR",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="Run through the multi-host driver (jax.distributed; every "
             "process reads its shard of the file manifest). Degenerates to "
             "the local engine in a single process.",
    )
    parser.add_argument(
        "--coordinator", help="jax.distributed coordinator address "
        "(host:port); with --num-processes/--process-id joins the processes",
    )
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument(
        "--resident", action="store_true",
        help="Load the dataset into device memory once, then run the query "
             "there (count queries; one dispatch per query)",
    )
    parser.add_argument(
        "--repeat", type=int, default=1,
        help="Run the query N times (interactive/serving simulation; "
             "pairs with --resident)",
    )


def cmd_query(args: argparse.Namespace) -> int:
    maybe_bounds = parse_aabb(args.bounds) if args.bounds else None
    maybe_class = args.classification
    maybe_time = None
    if args.time_range:
        parts = args.time_range.split(";")
        if len(parts) != 2:
            print('TIME-RANGE must be "start;end"', file=sys.stderr)
            return 1
        maybe_time = TimeRangeQuery(float(parts[0]), float(parts[1]))
    n_predicates = sum(
        p is not None for p in (maybe_bounds, maybe_class, maybe_time)
    )
    if n_predicates > 1:
        print(
            "Specifying BOUNDS and CLASS at the same time is invalid! "
            "Specify either BOUNDS or CLASS argument!",
            file=sys.stderr,
        )
        return 1
    if n_predicates == 0:
        print(
            "Found neither BOUNDS nor CLASS argument but exactly one of these "
            "arguments is required!",
            file=sys.stderr,
        )
        return 1

    plan = QueryPlan(
        bounds=BoundsQuery(maybe_bounds) if maybe_bounds is not None else None,
        classification=ClassQuery(maybe_class) if maybe_class is not None else None,
        time_range=maybe_time,
        density=DensityConfig(args.density, args.density_scope) if args.density else None,
        output_dir=Path(args.output) if args.output else None,
        print_points=args.print_points,
        parity_quirk=args.parity_quirk,
    )
    kwargs = {}
    if args.block_size:
        kwargs["block_size"] = args.block_size

    if args.resident:
        return _run_resident(args, plan)
    if args.distributed:
        return _run_distributed(args, plan)

    def execute():
        return run_query(
            args.input,
            plan,
            n_devices=args.devices,
            workers=args.workers,
            keep_going=args.keep_going,
            use_index=not args.no_index,
            # --print-points streams each hit as it is found (reference
            # StdOutCollector); nothing is buffered in RAM
            print_stream=sys.stdout if args.print_points else None,
            **kwargs,
        )

    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            result = execute()
        print(f"Profiler trace written to {args.profile}")
    else:
        result = execute()
    print(f"Searching {result.files_searched} files...")
    if plan.output_dir is not None:
        for f in result.output_files:
            print(f"Wrote {f}")
    print(f"Found {result.match_count} matching points")
    if args.stats:
        print(result.timer.report())
        print(
            f"  scanned {result.points_scanned} points "
            f"({result.mpts_per_s:.1f} Mpts/s)"
        )
        from . import engine as _engine

        print(f"  inflight device steps: {_engine.MAX_INFLIGHT_STEPS}")
    print(throughput_line(result.total_file_bytes, result.elapsed_seconds))
    return 0


def _run_distributed(args: argparse.Namespace, plan: QueryPlan) -> int:
    import time

    from .parallel import distributed

    distributed.initialize(args.coordinator, args.num_processes, args.process_id)
    kwargs = {}
    if args.block_size:
        kwargs["block_size"] = args.block_size
    t0 = time.perf_counter()
    if plan.density is not None:
        count = distributed.distributed_density(args.input, plan, **kwargs)
    elif plan.collects_points:
        count, emitter = distributed.distributed_collect(
            args.input, plan,
            output_dir=plan.output_dir,
            print_stream=sys.stdout if args.print_points else None,
            parity_quirk=plan.parity_quirk, **kwargs,
        )
        for f in emitter.output_files:
            print(f"Wrote {f}")
    else:
        count = distributed.distributed_count(
            args.input, plan, parity_quirk=plan.parity_quirk, **kwargs
        )
    import jax

    print(
        f"Found {count} matching points "
        f"({jax.process_count()} process(es), {len(jax.devices())} devices, "
        f"{time.perf_counter() - t0:.2f}s)"
    )
    return 0


def _run_resident(args: argparse.Namespace, plan: QueryPlan) -> int:
    import time

    from .parallel.resident import ResidentDataset

    attrs = []
    if plan.bounds is not None or plan.density is not None:
        attrs.append("position")
    if plan.classification is not None:
        attrs.append("classification")
    if plan.time_range is not None:
        attrs.append("gps_time")
    t0 = time.perf_counter()
    ds = ResidentDataset.load(
        args.input,
        attrs=tuple(attrs),
        block_size=args.block_size or (1 << 21),
        workers=args.workers,
    )
    load_s = time.perf_counter() - t0
    print(
        f"Resident: {ds.total_points} points, "
        f"{ds.resident_bytes / 1048576.0:.1f} MiB on device, loaded in {load_s:.2f}s"
    )
    if plan.collects_points:
        # full collect surface against resident columns: device predicate +
        # compaction, attributes gathered from disk only for hit rows
        t0 = time.perf_counter()
        count, emitter = ds.collect(
            plan,
            output_dir=plan.output_dir,
            print_stream=sys.stdout if args.print_points else None,
        )
        dt = time.perf_counter() - t0
        for f in emitter.output_files:
            print(f"Wrote {f}")
        print(f"Found {count} matching points")
        print(f"query in {dt * 1e3:.2f} ms against resident data")
        return 0
    count = ds.count(plan)  # warm (compile)
    t0 = time.perf_counter()
    for _ in range(args.repeat):
        count = ds.count(plan)
    per_query = (time.perf_counter() - t0) / max(args.repeat, 1)
    print(f"Found {count} matching points")
    print(
        f"{args.repeat} queries at {per_query * 1e3:.2f} ms/query "
        f"({ds.total_points / max(per_query, 1e-12) / 1e6:.0f} Mpts/s/query)"
    )
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    from .formats import las_to_last, las_to_laz, las_to_lazer

    src = Path(args.input)
    dst = Path(args.output)
    fmt = dst.suffix.lower().lstrip(".")
    if fmt == "last":
        las_to_last(src, dst)
    elif fmt == "lazer":
        las_to_lazer(src, dst, block_size=args.lazer_block_size)
    elif fmt == "laz":
        las_to_laz(src, dst, chunk_size=args.lazer_block_size,
                   strict_interop=args.strict_laz)
    else:
        print(f"Unsupported conversion target .{fmt}", file=sys.stderr)
        return 1
    print(f"Converted {src} -> {dst}")
    return 0


def cmd_index(args: argparse.Namespace) -> int:
    """Build block min/max sidecar indexes (improvements.md:3-10 realized)."""
    from .engine import discover_files
    from .formats import open_point_cloud
    from .index import build_index, save_index

    for f in discover_files(args.input):
        r = open_point_cloud(f)
        blocks, bitmap, gps_mm = build_index(r)
        p = save_index(f, blocks, bitmap, gps_mm, n_points=r.point_count)
        gps_note = " + gps" if gps_mm is not None else ""
        print(f"Indexed {f} -> {p} ({len(blocks)} blocks{gps_note})")
        r.close()
    return 0


def cmd_count_points(args: argparse.Namespace) -> int:
    """Header-only dataset point count (bin/count_points.rs:66-79)."""
    from .engine import discover_files
    from .formats.las import parse_las_header_file

    total = 0
    for f in discover_files(args.input):
        total += parse_las_header_file(f).point_count
    print(f"Total number of points: {total}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # argparse rejects option values that start with '-'; bounding boxes
    # legitimately have negative mins (the reference's clap sets
    # allow_hyphen_values, main.rs:209) — fold them into --opt=value form
    for opt in ("--bounds", "--time-range"):
        for k in range(len(argv) - 1):
            if argv[k] == opt and argv[k + 1].startswith("-"):
                argv[k : k + 2] = [f"{opt}={argv[k + 1]}"]
                break
    subcommands = (
        "query", "convert", "count-points", "experiments", "postgis", "serve", "index",
    )
    # Bare reference-style invocation: `query -i ... --bounds ...`
    if argv and argv[0] not in subcommands + ("-h", "--help"):
        argv = ["query"] + argv

    parser = argparse.ArgumentParser(
        prog="aqpc",
        description="Ad-hoc point cloud queries on a device mesh (LAS/LAZ/LAST/LAZER)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    qp = sub.add_parser("query", help="Run a bbox/class/density query")
    build_query_parser(qp)
    qp.set_defaults(fn=cmd_query)

    cp = sub.add_parser("convert", help="Convert LAS to LAST/LAZER")
    cp.add_argument("-i", "--input", required=True)
    cp.add_argument("-o", "--output", required=True)
    cp.add_argument("--lazer-block-size", type=int, default=50_000)
    cp.add_argument(
        "--strict-laz", action="store_true",
        help="LAZ output: refuse anything outside the maximally-conservative "
             "interop subset (formats 0-3, fixed chunks; "
             "docs/LASZIP_INTEROP.md)",
    )
    cp.set_defaults(fn=cmd_convert)

    np_ = sub.add_parser("count-points", help="Header-only total point count")
    np_.add_argument("-i", "--input", required=True)
    np_.set_defaults(fn=cmd_count_points)

    ix = sub.add_parser("index", help="Build block min/max sidecar indexes")
    ix.add_argument("-i", "--input", required=True)
    ix.set_defaults(fn=cmd_index)

    if argv and argv[0] == "experiments":
        from .experiments import main as exp_main

        return exp_main(argv[1:])
    if argv and argv[0] == "postgis":
        from .postgis import main as pg_main

        return pg_main(argv[1:])
    if argv and argv[0] == "serve":
        from .serve import main as serve_main

        return serve_main(argv[1:])

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
