"""Speaker auto-EQ CLI (counterpart of mathaudio_tpu/apps/autoeq.py): fit
a parametric EQ to a measured response and export it in EqualizerAPO /
RME / AUPreset formats — the end-to-end
speaker-EQ pipeline the reference workspace feeds (DE over Peq params
against a target SPL).

Input: CSV with `frequency,spl_db` rows (a speaker measurement). The
fitted EQ targets the *negative* deviation from the mean (flattening),
optionally after smoothing. The fit and the exporters' preamp run on
``--device`` (the GPU by default).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="autoeq")
    ap.add_argument("measurement", help="CSV: frequency,spl_db")
    ap.add_argument("-n", "--filters", type=int, default=7)
    ap.add_argument("--maxiter", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fmin", type=float, default=20.0)
    ap.add_argument("--fmax", type=float, default=20000.0)
    ap.add_argument("--apo", default=None, help="write EqualizerAPO config here")
    ap.add_argument("--rme", default=None, help="write RME TotalMix channel XML here")
    ap.add_argument("--aupreset", default=None, help="write AUNBandEQ plist here")
    ap.add_argument("--device", default=None,
                    help="torch device for the fit (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)

    rows = np.loadtxt(args.measurement, delimiter=",", skiprows=0, ndmin=2)
    freqs, spl = rows[:, 0], rows[:, 1]
    sel = (freqs >= args.fmin) & (freqs <= args.fmax)
    freqs, spl = freqs[sel], spl[sel]

    # target correction = -(deviation from the band mean)
    target = -(spl - spl.mean())

    from mathaudio_tpu_torch.dsp import (
        peq_format_apo,
        peq_format_aupreset,
        peq_format_rme_channel,
        peq_print,
    )
    from mathaudio_tpu_torch.optim import fit_peq

    res = fit_peq(
        freqs, target, n_filters=args.filters,
        freq_range=(args.fmin, args.fmax),
        maxiter=args.maxiter, seed=args.seed, device=args.device,
    )
    print(peq_print(res.peq), file=sys.stderr)
    print(
        json.dumps(
            {
                "rms_error_db": res.rms_error_db,
                "filters": [
                    {
                        "type": bq.filter_type.short_name,
                        "freq": float(bq.freq),
                        "q": float(bq.q),
                        "gain_db": float(bq.db_gain),
                    }
                    for _, bq in res.peq
                ],
            },
            indent=2,
        )
    )
    if args.apo:
        with open(args.apo, "w") as fh:
            fh.write(peq_format_apo("# mathaudio_tpu autoeq", res.peq, device=args.device))
    if args.rme:
        with open(args.rme, "w") as fh:
            fh.write(peq_format_rme_channel(res.peq))
    if args.aupreset:
        with open(args.aupreset, "w") as fh:
            fh.write(peq_format_aupreset(res.peq, "autoeq", device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
