"""Tiny sizes of the cells for CPU tests: the same code paths, small
widths and a small graph."""

import time

GRAPH = {"sizes": {"gene/protein": 600, "drug": 200, "disease": 300},
         "num_edges": 20000, "seed": 42}
KGE = "kge-rgcn-distmult.saint-r1024-k10"
GCL = "gcl-grace.nbr30x3-s128"
TYPED = "kge-rgcn-distmult.typed-full-k10"
OVERRIDES = {
    KGE: {"config": {"in_dim": 32, "hidden_dim": 16, "out_dim": 16,
                     "steps_per_epoch": 50, "graph": GRAPH},
          "traffic": {"roots": 16, "warmup_steps": 4, "trace_steps": 2}},
    GCL: {"config": {"in_dim": 32, "hidden_dim": 16, "out_dim": 16,
                     "epochs": 3, "graph": GRAPH},
          "traffic": {"seeds": 16, "fanouts": [5, 5], "warmup_steps": 4,
                      "trace_steps": 2}},
}
OVERRIDES[TYPED] = {"config": OVERRIDES[KGE]["config"],
                    "traffic": {"warmup_steps": 4, "trace_steps": 2}}



def bench() -> dict:
    """BENCHMARK.json, with the SAINT cell that the harness keeps ready
    (its traffic, driver and readers) though the benchmark leaves it
    out."""
    from portbench.runner import ROOT, load_json
    b = load_json(ROOT, "BENCHMARK.json")
    if all(w["name"] != KGE for w in b["workloads"]):
        b["workloads"].append({"name": KGE, "config": "kge-rgcn-distmult",
                               "traffic": "saint-r1024-k10", "chips": 1})
        for m in b["end_to_end"] + b["per_layer"]:
            if TYPED in m.get("workloads", []):
                m["workloads"].append(KGE)
        b["per_layer"] += [
            {"name": name, "unit": "%" if "roofline" in name else "ms",
             "workloads": [KGE]}
            for name in ("sample_ms.kge", "batch_wait_ms.kge",
                         "negscore_roofline.kge")]
    return b


def run(workload, seed=7, trace=False, fault=None, seconds=0.3,
        device="cpu"):
    from portbench.runner import run_cell
    return run_cell(workload, seed, seconds, trace, device,
                    time.perf_counter(), bench=bench(),
                    overrides=OVERRIDES[workload], fault=fault)
