"""Rehearse ``chip_smoke.py``'s telemetry phase on a host without a card.

    PYTHONPATH=src python scripts/rehearse_telemetry_phase.py

"cuda" maps to the CPU in every module that resolves a device, a CUDA
synchronise is a no-op, and each kernel wrapper on the phase's paths counts
its plain call as a launch, so every gate of ``telemetry_phase`` runs as on
the card (the kernels' plain versions stand in for the kernels).  The
recorder-off runs the earlier phases leave in ``chip_smoke.RECORDER_OFF``
are made first.  Times printed here are host times of the plain versions,
not device times.  About three minutes on an 8-core host.
"""
import importlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.cuda.is_available = lambda: True
torch.cuda.synchronize = lambda *a, **k: None
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def on_the_host(device):
    device = torch.device(device)
    return torch.device("cpu") if device.type == "cuda" else device


for name in ("repro_torch.experiment.driver", "repro_torch.experiment.sweep",
             "repro_torch.core.scan_engine", "repro_torch.core.oracle",
             "repro_torch.core.knowledge", "repro_torch.kernels.gating"):
    importlib.import_module(name).resolve_device = on_the_host

from repro_torch.kernels import fill, gating, geo_walk, knn, oracle_greedy  # noqa: E402


def counting(mod, fn_name, key):
    fn = getattr(mod, fn_name)

    def wrapper(*args, **kw):
        mod.launches[key] += 1
        return fn(*args, **kw)

    setattr(mod, fn_name, wrapper)


counting(knn, "knn_lookup", "knn_topk")
counting(fill, "capacity_fill", "capacity_fill")
counting(gating, "dep_release_csr", "dep_release")
counting(geo_walk, "geo_resolve", "geo_walk")
counting(oracle_greedy, "greedy_pass", "greedy_pass")

import chip_smoke as cs  # noqa: E402


def main():
    t = time.perf_counter()
    cs.reset_counts()
    cs.RECORDER_OFF["chaos-full"] = cs.chaos_full("cuda", "scan", "device")[0].to_json()
    cs.RECORDER_OFF["geo-full"] = cs.geo_full("cuda", "scan")[0].to_json()
    cs.RECORDER_OFF["dag"] = cs.run(cs.Scenario(dag=cs.DagConfig(), engine="scan", **cs.DAG),
                                    cs.DEFAULT_DAG_POLICIES)
    cs.RECORDER_OFF["main"] = cs.run(cs.Scenario(**cs.MAIN), cs.POLICIES)
    print(f"recorder-off runs {time.perf_counter() - t:.1f} s", flush=True)
    out = cs.telemetry_phase()
    print(json.dumps({k: v.get("events", v) if isinstance(v, dict) else v
                      for k, v in out.items()}))


if __name__ == "__main__":
    main()
