"""A throwaway benchmark root for CPU runs of the harness: the real
BENCHMARK.json plus a tiny configuration and its cell."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def tiny_root(tmp, traffic="medaka", metric_files=(), stage_flags=None) -> str:
    """A root under ``tmp`` whose BENCHMARK.json adds the cell
    ``tiny.<traffic>``; ``metric_files``: (name, source) of extra readers,
    each also added to ``per_layer``; ``stage_flags``: the traffic is a new
    file with these stage flags, not the benchmark's own of that name."""
    root = str(tmp)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "metrics"), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cell = f"tiny.{traffic}"
    spec["configs"].append({"name": "tiny", "source": "test",
                            "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a CPU test"})
    spec["workloads"].append({"name": cell, "config": "tiny",
                              "traffic": traffic, "chips": 1,
                              "why": "a CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    for name, source in metric_files:
        with open(os.path.join(root, "benchmark", "metrics",
                               f"{name}.py"), "w") as f:
            f.write(source)
        spec["per_layer"].append({"name": name, "unit": "reads",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "test", "moves": "reads_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    shutil.copy(os.path.join(HERE, "data", "tiny.json"),
                os.path.join(root, "benchmark", "configs", "tiny.json"))
    mix = os.path.join(root, "benchmark", "traffic", f"{traffic}.json")
    if stage_flags is None:
        shutil.copy(os.path.join(BENCH, "traffic", f"{traffic}.json"), mix)
    else:
        with open(mix, "w") as f:
            json.dump({"loop": "closed", "clients": 1,
                       "stage_flags": list(stage_flags),
                       "why": "a CPU test"}, f)
    return root


def quiet(*args, **kwargs):
    pass
