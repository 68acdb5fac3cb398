"""Re-derive roofline terms for every sweep cell from cached HLO text.

The dry-run saves compiled HLO to hlo_cache/; when the analyzer's byte
model improves, this script recomputes all terms without recompiling:

    PYTHONPATH=src python -m repro_torch.roofline.reanalyze \
        --hlo-dir hlo_cache --merge dryrun.jsonl --out dryrun.jsonl
"""
import argparse
import gzip
import json
import os

from repro_torch.configs import cell_by_name, get_config
from repro_torch.roofline.analysis import (
    PEAK_FLOPS,
    dominant_term,
    model_flops,
    roofline_terms,
)
from repro_torch.roofline.hlo_parser import analyze


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hlo-dir", default="hlo_cache")
    ap.add_argument("--merge", default="dryrun.jsonl",
                    help="existing records (memory_analysis fields kept)")
    ap.add_argument("--out", default="dryrun.jsonl")
    args = ap.parse_args()

    base = {}
    if os.path.exists(args.merge):
        for line in open(args.merge):
            r = json.loads(line)
            base[(r["arch"], r["cell"], r.get("mesh", "-"))] = r

    out = []
    for fname in sorted(os.listdir(args.hlo_dir)):
        if not fname.endswith(".hlo.gz"):
            continue
        arch, cell_name, meshtag = fname[:-len(".hlo.gz")].split("__")
        txt = gzip.open(os.path.join(args.hlo_dir, fname), "rt").read()
        corrected = analyze(txt)
        n_chips = 512 if meshtag == "2x16x16" else 256
        terms = roofline_terms(corrected["flops"], corrected["bytes"],
                               corrected["collective_bytes"])
        cfg = get_config(arch)
        cell = cell_by_name(cell_name)
        mf = model_flops(cfg, cell) / n_chips
        denom = max(terms.values()) or 1e-30
        rec = dict(base.get((arch, cell_name, meshtag), {}))
        rec.update({
            "arch": arch, "cell": cell_name, "mesh": meshtag,
            "status": "OK",
            "hlo_flops_per_device": corrected["flops"],
            "hlo_bytes_per_device": corrected["bytes"],
            "collective_bytes_per_device": corrected["collective_bytes"],
            "collectives": {k: v for k, v in corrected["collectives"].items()
                            if v},
            **{k: round(v, 6) for k, v in terms.items()},
            "dominant": dominant_term(terms),
            "model_flops_per_device": mf,
            "useful_flops_ratio": round(mf / corrected["flops"], 4)
            if corrected["flops"] else None,
            "roofline_fraction": round((mf / PEAK_FLOPS) / denom, 4),
        })
        out.append(rec)
    # keep SKIP records
    for key, r in base.items():
        if "SKIP" in str(r.get("status")):
            out.append(r)
    with open(args.out, "w") as f:
        for r in out:
            f.write(json.dumps(r) + "\n")
    print(f"re-analyzed {len(out)} records -> {args.out}")


if __name__ == "__main__":
    main()
