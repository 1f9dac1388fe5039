"""Trial worker entry point for :class:`SubprocessService`.

One trial per process (the NNI local training service spawns exactly
this shape: an interpreter running the user trainable, reporting
metrics through a side channel — here a JSON file written atomically).

The port's copy of ``tosem_tpu/tune/trial_worker.py``. :func:`worker_argv`
launches ``python -m tosem_tpu_torch.tune.trial_worker``: a fresh
interpreter, never a forked child, so the trainable may take the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# -- the launch/parse contract shared by every subprocess-backed trial
# host (SubprocessService and the node agent's trial plane): one
# definition so the worker flags and the progress format cannot diverge


def worker_argv(target: str, config_json: str, max_iterations: int,
                out_path: str, progress_path: str,
                checkpoint_path: "str | None" = None,
                checkpoint_freq: int = 5) -> list:
    """Command line for one trial-worker process. When
    ``checkpoint_path`` is given, a relaunch with the same path resumes
    a class trainable from its last checkpoint (crash-resume)."""
    argv = [sys.executable, "-m", "tosem_tpu_torch.tune.trial_worker",
            "--target", target, "--config", config_json,
            "--max-iterations", str(max_iterations),
            "--out", out_path, "--progress", progress_path]
    if checkpoint_path:
        argv += ["--checkpoint", checkpoint_path,
                 "--checkpoint-freq", str(checkpoint_freq)]
    return argv


def read_progress_incr(path: str, offset: int = 0) -> tuple:
    """Incremental progress read from a byte ``offset``: returns
    ``(new_entries, new_offset)``. Only COMPLETE lines are consumed —
    a torn tail (the worker mid-write) stays un-consumed so the next
    read retries it. Pollers keep the offset per trial, making a
    lifetime of polling O(total lines), not O(n²)."""
    if not os.path.exists(path):
        return [], offset
    with open(path, "rb") as f:
        f.seek(offset)
        blob = f.read()
    out = []
    consumed = 0
    for line in blob.split(b"\n"):
        # the final split element is either b"" (trailing newline —
        # nothing torn) or a partial line to leave for next time
        if consumed + len(line) + 1 > len(blob):
            break
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            break
        consumed += len(line) + 1
    return out, offset + consumed


def read_progress(path: str) -> list:
    """Whole-file convenience wrapper over :func:`read_progress_incr`."""
    return read_progress_incr(path, 0)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True, help="module:attr trainable")
    ap.add_argument("--config", required=True, help="JSON config dict")
    ap.add_argument("--max-iterations", type=int, default=100)
    ap.add_argument("--out", required=True, help="result JSON path")
    ap.add_argument("--progress", default=None,
                    help="JSONL path streaming one metric line per "
                    "report (the intermediate-result side channel a "
                    "manager polls to early-stop a RUNNING trial)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for crash-resume: written "
                    "atomically every --checkpoint-freq iterations; if "
                    "it already exists the trial resumes from it")
    ap.add_argument("--checkpoint-freq", type=int, default=5)
    args = ap.parse_args(argv)

    from tosem_tpu_torch.tune.providers import run_trial
    pf = open(args.progress, "a", buffering=1) if args.progress else None

    # chaos seam (cluster trial plane runs in its own process, so the
    # fault rides an env var): hard-exit once at iteration N, exactly
    # the way an OOM-killed / preempted trial dies. The marker file
    # makes the crash one-shot so the resumed process survives the same
    # iteration — deterministic for tests.
    crash_at = int(os.environ.get("TOSEM_CHAOS_TRIAL_CRASH_AT", "0") or "0")
    crash_marker = (args.checkpoint or args.out) + ".chaos-crashed"

    def metrics_cb(m):
        if pf is not None:
            pf.write(json.dumps(m) + "\n")
        if (crash_at and m.get("training_iteration", 0) >= crash_at
                and not os.path.exists(crash_marker)):
            with open(crash_marker, "w"):
                pass
            os._exit(1)

    out = run_trial(args.target, json.loads(args.config),
                    args.max_iterations, metrics_cb=metrics_cb,
                    checkpoint_path=args.checkpoint,
                    checkpoint_freq=args.checkpoint_freq)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, args.out)   # atomic: the manager never reads a torn file
    return 0


if __name__ == "__main__":
    sys.exit(main())
