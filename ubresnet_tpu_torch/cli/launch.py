"""Sweep launcher — the SLURM-array capability, process-local
(counterpart of ubresnet_tpu/cli/launch.py: the same flags, sweep spec,
per-job workdirs and logs; every command it spawns or writes runs a
``ubresnet_tpu_torch.cli`` module).

Runs N independent trainings (per-plane sweeps, hyperparameter scans)
from one base config plus per-job overrides, with per-job workdirs,
log redirection, staggered starts and elastic restarts (``--retries``
or ``max_restarts``: relaunch with resume=true), what
grid_scripts/sbatch_submit_larcv1_training.sh +
larcv1_run_training.sh do on the Tufts cluster; can also emit an
sbatch script for real SLURM clusters. ``--distributed N`` runs ONE
training as N processes (parallel/distributed.py), restarting the
whole gang on a failure. Each process trains on the card
(``UBTPU_PLATFORM=cpu`` in the environment puts the children on the
CPU, as the JAX package's do).

    python -m ubresnet_tpu_torch.cli.launch --sweep sweep.json \\
        [--parallel 2] [--retries 1] [--workdir sweep_out]
    python -m ubresnet_tpu_torch.cli.launch --distributed 2 \\
        --config cfg.json [--set key=value ...] [--retries 1]

Sweep spec (JSON):
  {"base": "cfg.json",
   "jobs": [
     {"name": "plane0", "set": {"train_data.plane": 0}},
     {"name": "plane1", "set": {"train_data.plane": 1}},
     {"name": "plane2", "set": {"train_data.plane": 2}}
   ],
   "stagger_seconds": 5}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Optional


def emit_sbatch(sweep_path: str, sweep: dict, out_path: str):
    """Emit a SLURM array script mirroring the reference's
    (sbatch_submit_larcv1_training.sh: gpu partition, array 0-N,
    per-job exec)."""
    n = len(sweep["jobs"])
    script = f"""#!/bin/bash
#SBATCH --job-name=ubtpu_sweep
#SBATCH --output=ubtpu_sweep.%A_%a.log
#SBATCH --array=0-{n - 1}
#SBATCH --time=3-0:00:00

python -m ubresnet_tpu_torch.cli.launch --sweep {sweep_path} --job-index $SLURM_ARRAY_TASK_ID
"""
    with open(out_path, "w") as f:
        f.write(script)
    os.chmod(out_path, 0o755)
    return out_path


def run_job(sweep: dict, index: int, workdir: str,
            retries: Optional[int] = None) -> int:
    """Run one sweep job; on nonzero exit relaunch it up to `retries`
    times with resume=true, continuing from the latest checkpoint —
    automatic elasticity for the reference's "high infant mortality
    ... check if they launched and rerun" grid workflow
    (grid_scripts/README.md), which was manual there."""
    job = sweep["jobs"][index]
    name = job.get("name", f"job{index}")
    jobdir = os.path.join(workdir, name)
    os.makedirs(jobdir, exist_ok=True)
    if retries is None:
        retries = int(job.get("max_restarts", sweep.get("max_restarts", 0)))
    args = [
        sys.executable,
        "-m",
        "ubresnet_tpu_torch.cli.train",
        "--config",
        os.path.abspath(sweep["base"]),
        "--set",
        f"checkpoint_dir={os.path.join(jobdir, 'checkpoints')}",
        "--set",
        f"log_dir={os.path.join(jobdir, 'logs')}",
    ]
    for key, val in job.get("set", {}).items():
        args += ["--set", f"{key}={json.dumps(val)}"]
    logfile = os.path.join(jobdir, "train.log")
    code = 1
    for attempt in range(retries + 1):
        cmd = list(args) + (["--set", "resume=true"] if attempt else [])
        with open(logfile, "w" if attempt == 0 else "a") as log:
            code = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT
            ).wait()
        if code == 0:
            break
        if attempt < retries:
            print(
                f"job {name} exited {code}; restarting with resume "
                f"({attempt + 1}/{retries})",
                flush=True,
            )
    return code


def run_distributed(config: str, n_processes: int, workdir: str,
                    coordinator: str = "127.0.0.1:0",
                    overrides=None, retries: int = 0) -> int:
    """ONE training across n_processes, one per card, over
    torch.distributed — the capability the reference lacks (it imported
    torch.distributed and never called it). Exports the UBTPU_* env
    contract consumed by parallel/distributed.initialize(); on a real
    cluster the scheduler sets the same variables per task (e.g. from
    SLURM_PROCID / the head-node address).

    With retries > 0 the whole gang restarts together on any process
    failure (the ranks step in lockstep — a lone survivor would hang
    in a collective, so stragglers are terminated first) and resumes
    from the latest checkpoint."""
    os.makedirs(workdir, exist_ok=True)
    code = 1
    for attempt in range(retries + 1):
        # fresh coordinator port per attempt: the previous attempt's
        # rendezvous store may hold the old one in TIME_WAIT
        host, _, port = coordinator.partition(":")
        if port in ("", "0"):
            import socket

            s = socket.socket()
            s.bind((host or "127.0.0.1", 0))
            port = str(s.getsockname()[1])
            s.close()
        coord = f"{host or '127.0.0.1'}:{port}"
        procs = []
        for pid in range(n_processes):
            env = dict(os.environ)
            env.update(
                UBTPU_COORDINATOR=coord,
                UBTPU_NUM_PROCESSES=str(n_processes),
                UBTPU_PROCESS_ID=str(pid),
            )
            cmd = [sys.executable, "-m", "ubresnet_tpu_torch.cli.train",
                   "--config", os.path.abspath(config)]
            for ov in overrides or []:
                cmd += ["--set", ov]
            if attempt:
                cmd += ["--set", "resume=true"]
            log = open(os.path.join(workdir, f"proc{pid}.log"),
                       "w" if attempt == 0 else "a")
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
            print(f"launched process {pid} (pid {procs[-1].pid})", flush=True)
        codes = [None] * n_processes
        killed = False
        while any(c is None for c in codes):
            for i, p in enumerate(procs):
                if codes[i] is None:
                    codes[i] = p.poll()
            failed = any(c not in (None, 0) for c in codes)
            live = [p for i, p in enumerate(procs) if codes[i] is None]
            if failed and live and not killed:
                print(
                    "a process failed; terminating the rest of the gang",
                    flush=True,
                )
                for p in live:
                    p.terminate()
                killed = True
            if live:
                time.sleep(0.5)
        code = max(codes)
        print(f"distributed run done: exit codes {codes}", flush=True)
        if code == 0:
            break
        if attempt < retries:
            print(
                f"restarting all {n_processes} processes with resume "
                f"({attempt + 1}/{retries})",
                flush=True,
            )
    return code


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run a training sweep")
    ap.add_argument("--sweep", help="sweep spec JSON")
    ap.add_argument("--distributed", type=int, default=None, metavar="N",
                    help="run ONE training as N torch.distributed "
                         "processes, one per card")
    ap.add_argument("--config", help="train config (with --distributed)")
    ap.add_argument("--coordinator", default="127.0.0.1:0",
                    help="coordinator host:port (with --distributed; "
                         "port 0 picks a free one)")
    ap.add_argument("--set", action="append", dest="overrides",
                    metavar="KEY=VALUE",
                    help="config overrides (with --distributed)")
    ap.add_argument("--workdir", default="sweep_out")
    ap.add_argument(
        "--job-index", type=int, default=None,
        help="run a single job (SLURM array mode)",
    )
    ap.add_argument(
        "--parallel", type=int, default=1,
        help="concurrent jobs when running locally",
    )
    ap.add_argument("--emit-sbatch", default=None, metavar="PATH",
                    help="write a SLURM array script and exit")
    ap.add_argument("--retries", type=int, default=None,
                    help="elastic restarts per job on failure (resume "
                         "from the latest checkpoint); sweep specs may "
                         "set max_restarts globally or per job")
    args = ap.parse_args(argv)

    if args.distributed:
        if not args.config:
            ap.error("--distributed requires --config")
        return run_distributed(args.config, args.distributed, args.workdir,
                               args.coordinator, args.overrides,
                               retries=args.retries or 0)
    if not args.sweep:
        ap.error("--sweep required (or use --distributed)")

    with open(args.sweep) as f:
        sweep = json.load(f)

    if args.emit_sbatch:
        path = emit_sbatch(os.path.abspath(args.sweep), sweep, args.emit_sbatch)
        print(f"wrote {path}")
        return 0

    os.makedirs(args.workdir, exist_ok=True)
    if args.job_index is not None:
        return run_job(sweep, args.job_index, args.workdir,
                       retries=args.retries)

    stagger = float(sweep.get("stagger_seconds", 0))
    procs: List[subprocess.Popen] = []
    codes = []
    for i, job in enumerate(sweep["jobs"]):
        name = job.get("name", f"job{i}")
        jobdir = os.path.join(args.workdir, name)
        os.makedirs(jobdir, exist_ok=True)
        cmd = [
            sys.executable, "-m", "ubresnet_tpu_torch.cli.launch",
            "--sweep", args.sweep, "--workdir", args.workdir,
            "--job-index", str(i),
        ]
        if args.retries is not None:
            cmd += ["--retries", str(args.retries)]
        log = open(os.path.join(jobdir, "launch.log"), "w")
        procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
        print(f"launched {name} (pid {procs[-1].pid})", flush=True)
        if stagger and i + 1 < len(sweep["jobs"]):
            time.sleep(stagger)  # staggered start (reference: GPUID*10s)
        while len([p for p in procs if p.poll() is None]) >= args.parallel:
            time.sleep(0.5)
    for p in procs:
        codes.append(p.wait())
    print(f"sweep done: exit codes {codes}")
    return max(codes) if codes else 0


if __name__ == "__main__":
    raise SystemExit(main())
