#!/usr/bin/env python
"""SIGKILL -> relaunch durability conformance harness (PyTorch port of
``scripts/durability_smoke.py``).

Proves the crash-consistency contract end to end, against REAL process
death (no in-process simulation):

1. Launch ``python -m consensus_tpu_torch.serve --state-dir DIR`` as a
   subprocess and resolve a few requests (recording their statements).
2. Queue a burst of further requests and ``SIGKILL`` the server while
   they are admitted-but-unresolved — the journal is left unsealed.
3. Relaunch with the same ``--state-dir``.  The server must replay the
   unresolved entries through normal admission (``replayed > 0``) and
   drain them to zero (``lost == 0``).
4. Re-ask EVERY request: each must answer 200 with a statement
   byte-identical to the first answer where one exists, and asking twice
   must serve from the idempotency cache both times (``dup == 0`` — no
   request is ever recomputed into a different answer).

Prints one JSON verdict on stdout and exits non-zero on any violation.
The server runs the fake backend by default; ``--backend torch`` with
``--backend-options`` runs the resident ``TorchBackend`` (on the card unless
``--device`` says otherwise), each life building its own.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def _payload(index: int) -> dict:
    return {
        "issue": f"Durability smoke issue {index}: should the city expand "
                 "night bus service?",
        "agent_opinions": {
            "Agent 1": f"Yes, shift workers need route {index}.",
            "Agent 2": "Only if daytime frequency is protected.",
        },
        "method": "best_of_n",
        "params": {"n": 4, "max_tokens": 32},
        "seed": 1000 + index,
        "request_id": f"smoke-{index}",
    }


def _launch(state_dir: str, server_args=()) -> tuple:
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensus_tpu_torch.serve",
         "--port", "0", "--max-inflight", "1", "--state-dir", state_dir,
         "--log-level", "WARNING", *server_args],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        cwd=str(REPO), env=env, text=True,
    )
    line = proc.stdout.readline()
    try:
        base_url = json.loads(line)["serving"]
    except Exception:
        proc.kill()
        raise RuntimeError(f"server did not announce itself: {line!r}")
    return proc, base_url


def _post(base_url: str, payload: dict, timeout: float = 30.0) -> dict:
    request = urllib.request.Request(
        base_url.rstrip("/") + "/v1/consensus",
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(request, timeout=timeout) as response:
        return json.loads(response.read().decode("utf-8"))


def _healthz(base_url: str) -> dict:
    with urllib.request.urlopen(
        base_url.rstrip("/") + "/healthz", timeout=5.0
    ) as response:
        return json.loads(response.read().decode("utf-8"))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--state-dir", default=None,
                        help="durable state dir (default: fresh tempdir)")
    parser.add_argument("--resolved", type=int, default=3,
                        help="requests resolved before the kill")
    parser.add_argument("--inflight", type=int, default=5,
                        help="requests admitted-but-unresolved at the kill")
    parser.add_argument("--backend", default="fake",
                        help="server backend: fake | torch | tpu "
                             "(default: fake)")
    parser.add_argument("--backend-options", default=None, metavar="JSON",
                        help="JSON object of backend constructor options")
    parser.add_argument("--device", default=None,
                        help="device of a torch/tpu backend (default: cuda)")
    args = parser.parse_args(argv)

    state_dir = args.state_dir or tempfile.mkdtemp(prefix="durability_smoke_")
    server_args = ["--backend", args.backend]
    if args.backend_options is not None:
        server_args += ["--backend-options", args.backend_options]
    if args.device is not None:
        server_args += ["--device", args.device]

    verdict = {"state_dir": state_dir, "resolved_before_kill": 0,
               "replayed": 0, "lost": None, "dup": 0, "mismatches": 0,
               "ok": False}

    # -- life 1: resolve a few, then SIGKILL with a full queue ------------
    proc, base_url = _launch(state_dir, server_args)
    answers = {}
    try:
        for i in range(args.resolved):
            body = _post(base_url, _payload(i))
            answers[i] = body["statement"]
        verdict["resolved_before_kill"] = len(answers)
        # Queue the victim burst: max-inflight is 1, so most of these sit
        # admitted (journaled) but unresolved — poll the journal's own
        # unresolved gauge and kill the instant it shows a backlog, so
        # the SIGKILL deterministically lands mid-load.
        def _fire_and_forget(payload: dict) -> None:
            try:
                _post(base_url, payload, timeout=60.0)
            except Exception:
                pass  # the SIGKILL severs these connections — expected

        burst = [threading.Thread(
            target=_fire_and_forget, args=(_payload(args.resolved + j),),
            daemon=True) for j in range(args.inflight)]
        for thread in burst:
            thread.start()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            wal_stats = (_healthz(base_url).get("durability") or {}).get(
                "wal") or {}
            if wal_stats.get("unresolved", 0) >= max(2, args.inflight - 2):
                break
            time.sleep(0.005)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10.0)

    # -- life 2: relaunch, replay, verify exactly-once --------------------
    proc, base_url = _launch(state_dir, server_args)
    try:
        # Replay happens inside start() (before the announce line), but
        # the replayed requests resolve asynchronously — wait for the
        # journal to drain to zero unresolved.
        deadline = time.monotonic() + 60.0
        wal_stats = {}
        while time.monotonic() < deadline:
            wal_stats = (_healthz(base_url).get("durability") or {}).get(
                "wal") or {}
            if wal_stats.get("unresolved", 1) == 0:
                break
            time.sleep(0.1)
        verdict["replayed"] = wal_stats.get("replayed", 0)
        verdict["lost"] = wal_stats.get("unresolved")
        # Exactly-once at the result layer: every request answers, twice,
        # byte-identically; the second ask must come from the idempotency
        # cache (a recompute that could diverge counts as a duplicate).
        for i in range(args.resolved + args.inflight):
            first = _post(base_url, _payload(i))
            second = _post(base_url, _payload(i))
            if i in answers and first["statement"] != answers[i]:
                verdict["mismatches"] += 1
            if (first["statement"] != second["statement"]
                    or not second.get("idempotent_replay")):
                verdict["dup"] += 1
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            proc.kill()

    verdict["ok"] = (verdict["replayed"] > 0 and verdict["lost"] == 0
                     and verdict["dup"] == 0 and verdict["mismatches"] == 0)
    print(json.dumps(verdict, indent=2))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
