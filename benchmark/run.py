"""The port's benchmark: libraries through ``ngspeciesid_tpu_torch.cli.main``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One client in a closed loop, as a lab runs NGSpeciesID over its libraries:
the harness writes a library's fastq (untimed), calls ``cli.main`` on it with
the cell's flags and a fresh output folder, and starts the next library when
that call has returned.  The window is the sum of the calls' walls; the
library in flight when it reaches ``--seconds`` is finished and counted.
Set-up (``setup_s``) is everything before the window: the imports, the CUDA
context, the kernels' library and one small warm-up library of the cell's
own flags.  ``--trace 1`` runs the window under ``torch.profiler`` and
reports the cell's per-layer metrics instead of its end-to-end ones.

After the window the references under ``reference/`` judge what it produced
(``check.py``); the numbers compared are printed, each with its limit, as
the last lines of standard error and under ``checks`` in the result, the
last line of standard output.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, ``traffic/<traffic>.json`` and ``metrics/<metric>.py``
(a ``read(records)`` that returns a number, or None where it finds nothing).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Top-level module names that a run must not have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "ngspeciesid_tpu")
#: Build and kernel caches, at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".bench_cache")


class NoResult(Exception):
    """The run ends without a result line, with this exit code."""

    def __init__(self, code: int, msg: str) -> None:
        super().__init__(msg)
        self.code = code


@dataclass
class Lib:
    """One library of the window."""
    index: int
    reads: int
    fastq: str
    out: str
    library: object
    wall: float = 0.0
    walls: Dict[str, float] = field(default_factory=dict)
    engine: Dict[str, float] = field(default_factory=dict)
    ok: bool = True


@dataclass
class Records:
    """What a metric's reader reads."""
    cell: str
    setup_s: float
    window_s: float
    libraries: List[Lib]
    calls: list                   # every DP call's lengths (hooks.Launch)
    launches: Dict[str, tuple]
    trace: object = None


def forbidden_modules(names) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole, so ``ngspeciesid_tpu_torch`` passes)."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT) -> None:
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise NoResult(2, f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise NoResult(2, f"no configuration named {name!r}")

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.root, "benchmark", "traffic",
                                      f"{name}.json"))

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, name: str):
        for d in (os.path.join(self.root, "benchmark", "metrics"),
                  os.path.join(HERE, "metrics")):
            path = os.path.join(d, f"{name}.py")
            if os.path.isfile(path):
                spec = importlib.util.spec_from_file_location(
                    f"_bench_metric_{name.replace('.', '_')}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                return mod.read
        raise NoResult(2, f"no reader benchmark/metrics/{name}.py")


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT, control: str = "", backend: str = "cuda",
             require_chip: bool = True, log=print) -> dict:
    """One run of a cell; returns the result object (``checks`` last)."""
    bench = Bench(root)
    cell = bench.cell(cell_name)
    chips = int(cell["chips"])
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(CACHE, "cuda"))
    import torch

    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise NoResult(3, f"cell {cell_name} needs {chips} CUDA device(s); "
                          f"torch sees {torch.cuda.device_count()}")
    os.environ["NGSID_STATS_BACKEND"] = backend
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    wanted = bench.metrics(cell_name, trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in wanted}
    try:
        from ngspeciesid_tpu_torch import cli
        from ngspeciesid_tpu_torch.cluster import engine
        from ngspeciesid_tpu_torch.ops import align_moves, align_stats
    except ImportError as e:
        raise NoResult(4, f"the program does not import: {e}")

    from benchmark import hooks
    from benchmark import trace as tr
    from benchmark.check import CLUSTER_LIBRARIES, Checker
    from benchmark.faults import CONTROLS, FAULTS
    from benchmark.traffic import Generator

    on_card = backend == "cuda"
    flags = [str(f) for f in config["flags"]] + [
        str(f) for f in traffic["stage_flags"]]
    gen = Generator(config["library"], seed)
    work = tempfile.mkdtemp(prefix="ngsid_bench_")
    undo = None
    recorder = hooks.Recorder(keep=CLUSTER_LIBRARIES, seed=seed)

    def one(index: int, library, timed: bool) -> Lib:
        fastq = os.path.join(work, f"lib{index}.fastq")
        with open(fastq, "wb") as f:
            f.write(library.fastq)
        # the library's bytes, and the last library's outputs, reach the
        # disk before the clock starts, not during the call
        os.sync()
        lib = Lib(index, library.n_reads, fastq,
                  os.path.join(work, f"out{index}"), library)
        argv = flags + ["--fastq", fastq, "--outfolder", lib.out]
        engine.reset_perf_counters()
        recorder.new_library(index)
        t0 = time.perf_counter()
        try:
            with (hooks._range("library") if trace and timed
                  else contextlib.nullcontext()):
                lib.ok = cli.main(argv, stage_walls=lib.walls) == 0
                if on_card:
                    torch.cuda.synchronize()
        except Exception as e:  # a library that fails is counted, not fatal
            log(f"library {index} failed: {type(e).__name__}: {e}",
                file=sys.stderr)
            lib.ok = False
        lib.wall = time.perf_counter() - t0
        lib.engine = dict(engine.PERF_COUNTERS)
        if timed:
            recorder.end_library(library.n_reads)
        return lib

    try:
        warm = one(-1, gen.warmup(), timed=False)
        if not warm.ok:
            raise NoResult(5, "the warm-up library failed")
        shutil.rmtree(warm.out, ignore_errors=True)
        os.remove(warm.fastq)
        if control:
            undo = {**CONTROLS, **FAULTS}[control]()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T0

        align_stats.reset_counts()
        align_moves.reset_counts()
        recorder.install(ranges=trace)
        prof = None
        if trace:
            cpu_only = [torch.profiler.ProfilerActivity.CPU]
            prof = tr.profile(None if on_card else cpu_only)
        libs: List[Lib] = []
        if prof is not None:
            prof.start()
        try:
            window = 0.0
            while window < seconds:
                libs.append(one(len(libs), gen.library(len(libs)), True))
                window += libs[-1].wall
        finally:
            if prof is not None:
                prof.stop()
            recorder.uninstall()
            if undo is not None:
                undo()
        launches = {"stats": (align_stats.LAUNCHES, align_stats.PAIRS),
                    "moves": (align_moves.LAUNCHES, align_moves.PAIRS)}
        device = device_info(chips) if on_card else {
            "platform": "cpu", "kind": "cpu", "count": 0}
        device["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(0)) if on_card else 0
        trace_obj = None
        if prof is not None:
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace_obj = tr.from_chrome(path)
            os.remove(path)
            device["busy_s"] = trace_obj.busy_s
            device["window_s"] = trace_obj.window_s

        # a trace without a card holds no device time to report
        records = Records(cell_name, setup_s, window, libs, recorder.launches,
                          launches,
                          trace_obj if on_card else None)
        metrics = {}
        for m in wanted:
            value = readers[m["name"]](records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {"correct": False, "attempted": len(libs),
                  "failed": sum(not lib.ok for lib in libs),
                  "metrics": metrics, "device": device}
        if trace_obj is not None:
            result["breakdown"] = {"device_ops": trace_obj.top_ops(),
                                   "idle_gaps": trace_obj.idle_by_layer()}
        log(json.dumps({"libraries": [
            {"index": lib.index, "reads": lib.reads, "wall": lib.wall,
             "walls": lib.walls, "engine": lib.engine} for lib in libs],
            "launches": launches}))

        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        checker = Checker(flags, seed, "cuda:0" if on_card else "cpu")
        done = [lib for lib in libs if lib.ok]
        checker.sorted_reads(done)
        checker.kernels(recorder.calls)
        checker.clustering(done, recorder.passes, recorder.calls,
                           set(recorder.sampled))
        if "--consensus" in flags:
            checker.consensus(done)
        log(f"judged: {json.dumps(checker.judged)}", file=sys.stderr)
        for name, whys in checker.faults.items():
            for why in whys[:5]:
                log(f"fault {name}: {why}", file=sys.stderr)
        result["correct"] = checker.correct() and all(lib.ok for lib in libs)
        result["checks"] = {name: {"value": v, "limit": limit}
                            for name, (v, limit) in checker.values.items()}
        return result
    finally:
        if undo is not None:
            undo()
        shutil.rmtree(work, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="",
                    help="run with a control or a planted fault (faults.py); "
                         "the check must then call the run wrong")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), control=args.control)
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return e.code
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"no result: modules loaded that the port must not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 6
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
