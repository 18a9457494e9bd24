"""Corpus-scaling ladder for the pretrained speech encoder (VERDICT r3 #3).

EX-ANTE SHIP CRITERION — fixed here, before any rung runs:

    ship_score = mean(resonator_pair_acc, heldout_fx_pair_acc)
                 on the LARGE eval (48 unseen words / 96 confusable pairs),
    subject to confusable_pair_acc (formant, in-domain) >= 0.80.

The two transfer channels are the only honest proxy for real-world use;
the in-domain number is a FLOOR, not a tiebreaker (round-3 verdict: v3
out-scored v6 on the circular in-domain metric and shipped wrongly).
heldout_fx_pair_acc keeps its round-3 definition (mean of formant_fx and
resonator_fx) so scores stay comparable to the recorded v3-v8 numbers.

Recorded baselines (large eval, round 3; formant/resonator/fx pair acc):

    v3 shipped : 0.844 / 0.792 / 0.733 -> score 0.7625  (no supcon)
    v6         : 0.830 / 0.811 / 0.741 -> score 0.7760  (supcon 0.5)

Rungs — v6's recipe (supcon 0.5, wide128, 12k steps, batch 256) with ONE
corpus axis scaled each, per the round-3 verdict ("corpus is binding" was
asserted from capacity experiments only; this ladder measures it):

    L1  : vocab 3072 x 24 variants, union   (vocab axis, 2x)
    L2  : vocab 1536 x 48, union            (speaker axis, 2x)
    L3  : vocab 1536 x 24, union3           (channel axis: + the
          sinusoidal-model harmonic channel, tts.harmonic_synthesize)
    v6r : vocab 1536 x 24, union            (v6 reproduction / anchor,
          run LAST — only needed as the ship candidate if no scaling
          rung beats it)

Usage:
    python tools/encoder_ladder.py \
        [--rungs L1,L2,L3,v6r] [--steps 12000] [--workdir campaign/encoder_ladder]

Each rung synthesizes its corpus (cache under /tmp — reproducible from
seeds, too large to commit), trains, runs the large transfer eval, and
appends to <workdir>/ladder.json. Rungs with an existing result are
skipped, so the ladder is resumable.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNGS = {
    "L1": dict(vocab=3072, variants=24, channels="union"),
    "L2": dict(vocab=1536, variants=48, channels="union"),
    "L3": dict(vocab=1536, variants=24, channels="union3"),
    "v6r": dict(vocab=1536, variants=24, channels="union"),
    # round-2 rung: both winning axes together (L1 vocab x L2 speakers),
    # run after L1/L2 each beat the anchor individually
    "L4": dict(vocab=3072, variants=48, channels="union"),
    # round-3 rung (VERDICT r4 weak #6): L3's "third channel is negative"
    # verdict was budget-confounded — at FIXED clip budget, union3 dilutes
    # per-channel variants. L5 re-asks the question at MATCHED per-channel
    # variants on the L4 recipe: 24/channel x 3 channels = 72 variants,
    # 1.5x L4's clip budget. If the harmonic channel helps, L5 > L4.
    "L5": dict(vocab=3072, variants=72, channels="union3"),
}

RECORDED = {   # round-3 large-eval numbers (docs/NEXT_ROUND.md, sidecar)
    "v3": {"confusable_pair_acc": 0.844, "resonator_pair_acc": 0.792,
           "heldout_fx_pair_acc": 0.733},
    "v6": {"confusable_pair_acc": 0.830, "resonator_pair_acc": 0.811,
           "heldout_fx_pair_acc": 0.741},
}

IN_DOMAIN_FLOOR = 0.80


def ship_score(report: dict):
    """(score, floor_ok) under the ex-ante criterion above."""
    score = (report["resonator_pair_acc"]
             + report["heldout_fx_pair_acc"]) / 2.0
    return score, report["confusable_pair_acc"] >= IN_DOMAIN_FLOOR


def run(cmd, env=None):
    print(f"[ladder] $ {' '.join(cmd)}", flush=True)
    e = dict(os.environ)
    e["PYTHONPATH"] = REPO
    if env:
        e.update(env)
    subprocess.run(cmd, check=True, env=e, cwd=REPO)


def run_rung(name, spec, steps, workdir, cachedir):
    asset = os.path.join(workdir, f"{name}.msgpack")
    result = os.path.join(workdir, f"{name}_eval.json")
    if os.path.exists(result):
        print(f"[ladder] {name}: result exists, skipping", flush=True)
        return json.load(open(result))
    t0 = time.time()
    if not os.path.exists(asset):
        run([sys.executable, "-m", "nanowakeword_tpu.train.pretrain_encoder",
             "--out", asset, "--vocab", str(spec["vocab"]),
             "--variants", str(spec["variants"]),
             "--channels", spec["channels"], "--arch", "wide128",
             "--steps", str(steps), "--contrastive", "0.5",
             "--cache", os.path.join(cachedir, f"corpus_{name}.npz")])
    run([sys.executable, "tools/eval_encoder_transfer.py", asset,
         "--words", "48", "--pairs", "96", "--out", result])
    report = json.load(open(result))
    report["wall_seconds_total"] = round(time.time() - t0, 1)
    json.dump(report, open(result, "w"), indent=1)
    return report


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--rungs", default="L1,L2,L3,v6r")
    p.add_argument("--steps", type=int, default=12000)
    p.add_argument("--workdir", default="campaign/encoder_ladder")
    p.add_argument("--cachedir", default="/tmp/encoder_ladder")
    args = p.parse_args()
    # subprocesses run with cwd=REPO; resolve relative dirs against it so
    # this script works from any launch directory
    if not os.path.isabs(args.workdir):
        args.workdir = os.path.join(REPO, args.workdir)
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.cachedir, exist_ok=True)

    # read-modify-write: merge this invocation's rungs into the existing
    # record (running `--rungs L4` once clobbered L1-L3/v6r out of the
    # working tree — VERDICT r4 weak #2)
    ladder_path = os.path.join(args.workdir, "ladder.json")
    ladder = {}
    prior_decision = {}
    if os.path.exists(ladder_path):
        existing = json.load(open(ladder_path))
        ladder = existing.get("rungs", {})
        prior_decision = existing.get("decision", {})
    for name in args.rungs.split(","):
        name = name.strip()
        report = run_rung(name, RUNGS[name], args.steps,
                          args.workdir, args.cachedir)
        score, ok = ship_score(report)
        ladder[name] = {**report, "ship_score": round(score, 4),
                        "in_domain_floor_ok": bool(ok)}
        print(f"[ladder] {name}: score={score:.4f} floor_ok={ok} "
              f"(formant {report['confusable_pair_acc']:.3f} / resonator "
              f"{report['resonator_pair_acc']:.3f} / fx "
              f"{report['heldout_fx_pair_acc']:.3f})", flush=True)
        eligible = {k: v for k, v in ladder.items()
                    if v.get("in_domain_floor_ok")}
        winner = max(eligible, key=lambda k: eligible[k]["ship_score"],
                     default=None)
        out = dict(criterion=__doc__.split("Usage:")[0],
                   recorded={k: {**v, "ship_score": round(
                       (v["resonator_pair_acc"]
                        + v["heldout_fx_pair_acc"]) / 2, 4)}
                       for k, v in RECORDED.items()},
                   rungs=ladder)
        if winner is not None:
            # preserve hand-recorded decision extras (CI records, extended
            # notes); regenerate the note only if the winner changed
            out["decision"] = {
                **prior_decision,
                "winner": winner,
                "ship_score": ladder[winner]["ship_score"],
            }
            if prior_decision.get("winner") != winner \
                    or "note" not in prior_decision:
                out["decision"]["note"] = (
                    f"{winner} leads all floor-passing rungs under the "
                    "ex-ante criterion; recorded v3 (shipped through "
                    "round 4) scores 0.7625")
        json.dump(out, open(ladder_path, "w"), indent=1)
    print("[ladder] done", flush=True)


if __name__ == "__main__":
    main()
