"""HPO experiment CLI — the ``nnictl`` surface.

Subcommand shape mirrors the reference (`nnictl create --config exp.yaml`,
`nnictl experiment status/list/stop`, `nni/tools/nnictl/`): experiments
live in a shared SQLite KV (``--db``), so status and results work from
any process after the run.

Usage::

    python -m tosem_tpu_torch.hpo_cli create --spec exp.yaml [--db hpo.db]
    python -m tosem_tpu_torch.hpo_cli run    --name quad-demo [--db hpo.db]
    python -m tosem_tpu_torch.hpo_cli status --name quad-demo
    python -m tosem_tpu_torch.hpo_cli results --name quad-demo [--top 5]
    python -m tosem_tpu_torch.hpo_cli list
    python -m tosem_tpu_torch.hpo_cli delete --name quad-demo

The port's copy of ``tosem_tpu/hpo_cli.py``, with the same default
``--db``. A trial that trains on the card runs through a training
service (``"training_service": "subprocess"`` in the spec), each trial a
fresh interpreter.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional

from tosem_tpu_torch.tune.experiment import ExperimentManager

DEFAULT_DB = "results/hpo.db"
COMMANDS = ("create", "run", "status", "results", "list", "delete")


def _parse(argv: List[str]) -> Dict[str, Any]:
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: hpo_cli <{'|'.join(COMMANDS)}> "
                         "[--name N] [--spec FILE] [--db FILE] [--top K] "
                         "[--force] [--verbose]")
    opts: Dict[str, Any] = {"cmd": argv[0], "db": DEFAULT_DB,
                            "name": None, "spec": None, "top": 0,
                            "verbose": False, "force": False}
    i = 1
    while i < len(argv):
        a = argv[i]
        if a == "--verbose":
            opts["verbose"] = True
            i += 1
            continue
        if a == "--force":
            opts["force"] = True
            i += 1
            continue
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
        elif a.startswith("--") and i + 1 < len(argv):
            k, v = a[2:], argv[i + 1]
            i += 1
        else:
            raise SystemExit(f"unexpected argument {a!r}")
        if k not in ("name", "spec", "db", "top"):
            raise SystemExit(f"unknown flag --{k}")
        if k == "top":
            try:
                v = int(v)
            except ValueError:
                raise SystemExit(f"--top needs an integer, got {v!r}")
        opts[k] = v
        i += 1
    return opts


def _load_spec(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    try:
        import yaml
        return yaml.safe_load(text)
    except ImportError:
        return json.loads(text)


def main(argv: Optional[List[str]] = None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:      # `hpo_cli status | head` is fine
        return 0


def _main(argv: Optional[List[str]] = None) -> int:
    opts = _parse(sys.argv[1:] if argv is None else list(argv))
    mgr = ExperimentManager(path=opts["db"])
    cmd = opts["cmd"]
    if cmd == "create":
        if not opts["spec"]:
            raise SystemExit("create needs --spec FILE")
        name = mgr.create(_load_spec(opts["spec"]))
        print(f"created experiment {name!r}")
        return 0
    if cmd == "list":
        for e in mgr.list():
            print(f"{e['name']:24s} {e.get('status', '?'):8s} "
                  f"best={e.get('best_score')}")
        return 0
    if not opts["name"]:
        raise SystemExit(f"{cmd} needs --name")
    name = opts["name"]
    if cmd == "run":
        state = mgr.run(name, verbose=opts["verbose"],
                        force=opts["force"])
        print(f"done: best_score={state['best_score']:.6g} "
              f"best_config={json.dumps(state['best_config'])}")
        return 0
    if cmd == "status":
        print(json.dumps({k: v for k, v in mgr.status(name).items()
                          if k != "trials"}, indent=2, sort_keys=True))
        return 0
    if cmd == "results":
        rows = mgr.results(name)
        mode = mgr.spec(name).get("mode", "min")
        scored = [r for r in rows if r["best_score"] is not None]
        # scores are raw metric values: ascending = best-first for min
        scored.sort(key=lambda r: r["best_score"],
                    reverse=(mode == "max"))
        top = scored[:opts["top"]] if opts["top"] else scored
        for r in top:
            print(f"{r['trial_id']:10s} {r['status']:10s} "
                  f"iters={r['iterations']:4d} "
                  f"score={r['best_score']:.6g} "
                  f"config={json.dumps(r['config'])}")
        return 0
    if cmd == "delete":
        ok = mgr.delete(name)
        print("deleted" if ok else "not found")
        return 0 if ok else 1
    raise SystemExit(f"unhandled command {cmd}")


if __name__ == "__main__":
    sys.exit(main())
