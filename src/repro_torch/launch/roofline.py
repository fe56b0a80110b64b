"""Roofline of the dry-run records: the counterpart of
``repro/launch/roofline.py``, on the H100's constants.

Per (arch x shape x mesh) record of ``launch/dryrun.py``, three terms:

    compute    = (matmul FLOPs + kernel operations) / (chips * 989e12)
    memory     = HBM bytes        / (chips * 3.35e12 B/s)
    collective = collective bytes / 450e9 B/s (one NVLink direction)

(H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate, NVLink's
900 GB/s in both directions together; the rates ``PERF.md`` section 6's
bounds use.) The numerators come from the census: the matmuls' FLOPs
(``FlopCounterMode``) plus the hand-written kernels' analytic operations;
the HBM bytes the larger of the census's (every ATen op's operands and
results, and the kernels' analytic bytes) and the family's analytic
traffic model (the JAX module's); the collective bytes the census's
(none on one device). ``model_flops`` (the bundle's analytic 6ND / 2ND
and the like) is reported beside them, and the fit of the peak of live
bytes against the card's memory: the card's own where one is present
(``torch.cuda.get_device_properties``), else 80 GB.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

HW = {
    "peak_flops": 989e12,     # dense bf16 per card (H100 SXM)
    "hbm_bw": 3.35e12,        # B/s per card
    "link_bw": 450e9,         # B/s, one NVLink direction
    "hbm_cap": 80e9,          # H100 80GB
}

__all__ = ["HW", "analyze_cell", "analyze_dir", "hbm_capacity", "main"]


def hbm_capacity() -> float:
    """The card's memory in bytes, else the data sheet's."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HW["hbm_cap"]


def _analytic_hbm(meta: dict) -> float:
    """Per-step global HBM traffic (bytes), coarse but family-aware (the
    JAX roofline's model)."""
    fam = meta.get("family")
    if fam == "lm":
        N, Na = meta["params"], meta["active_params"]
        # train: bf16 weights read forward, backward and in the remat
        # forward, float32 masters, m and v read and written; serving:
        # the weights once; the KV cache read at decode; 48 bytes of
        # activations a token and layer
        weights = Na * 2 * 3 + N * 4 * 5 if meta["kind"] == "train" \
            else Na * 2
        return weights + meta.get("kv_cache_bytes", 0) \
            + meta["tokens"] * meta["n_layers"] * 48
    if fam == "gnn":
        E, N, L = meta["edges"], meta["nodes"], meta["n_layers"]
        return L * (E + N) * meta["d_hidden"] * 4 * 6
    if fam == "recsys":
        return meta["weight_bytes"] * 0.01 + meta["batch"] * 4096
    return meta.get("weight_bytes", 0)


def analyze_cell(rec: dict, hbm_cap: float | None = None) -> dict:
    chips = rec["n_devices"]
    meta, census = rec["meta"], rec["census"]
    cap = hbm_capacity() if hbm_cap is None else hbm_cap
    model_flops = float(meta.get("model_flops", 0.0))
    flops = float(census["flops"]) + float(census["kernel_ops"])
    hbm = max(float(census["bytes_accessed"]), _analytic_hbm(meta) / chips)
    coll = float(sum(c["bytes"] for c in census["collectives"].values()))
    terms = {"compute_s": flops / (chips * HW["peak_flops"]),
             "memory_s": hbm / HW["hbm_bw"],
             "collective_s": coll / HW["link_bw"]}
    dominant = max(terms, key=terms.get)
    total = max(sum(terms.values()), 1e-30)
    peak = rec["memory"]["peak_device_bytes"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips, "model_flops": model_flops, "flops_used": flops,
        "useful_ratio": round(model_flops / max(flops, 1.0), 4),
        "hbm_bytes_dev": hbm, "coll_bytes_dev": coll,
        "collective_by_kind": census["collectives"],
        **{k: round(v, 9) for k, v in terms.items()},
        "dominant": dominant[:-2],
        "bound_fraction": round(terms[dominant] / total, 4),
        "peak_gib": round(peak / 2**30, 2),
        "hbm_cap_gib": round(cap / 2**30, 2),
        "fits_hbm": bool(peak <= cap),
        "roofline_step_s": round(terms[dominant], 9),
    }


def analyze_dir(dryrun_dir: str | Path) -> list[dict]:
    out = []
    cap = hbm_capacity()
    for f in sorted(Path(dryrun_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        if not rec.get("ok"):
            out.append({"arch": rec.get("arch"), "shape": rec.get("shape"),
                        "mesh": rec.get("mesh"), "error": rec.get("error")})
            continue
        out.append(analyze_cell(rec, cap))
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-dir", default="build/dryrun")
    ap.add_argument("--out", default="build/roofline.json")
    args = ap.parse_args(argv)
    rows = analyze_dir(args.dryrun_dir)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    hdr = (f"{'arch':22s} {'shape':14s} {'mesh':8s} {'dominant':10s} "
           f"{'frac':>6s} {'compute_s':>11s} {'memory_s':>11s} "
           f"{'collect_s':>11s} {'peak GiB':>9s} {'fits':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if "error" in r:
            print(f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:8s} FAILED")
            continue
        print(f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:8s} "
              f"{r['dominant']:10s} {r['bound_fraction']:6.2f} "
              f"{r['compute_s']:11.3e} {r['memory_s']:11.3e} "
              f"{r['collective_s']:11.3e} {r['peak_gib']:9.2f} "
              f"{str(r['fits_hbm']):>5s}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
