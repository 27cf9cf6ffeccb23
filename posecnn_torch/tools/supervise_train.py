"""Stall-tolerant training supervisor for the port's trainer.

Port of `tools/supervise_train.py`, with the same flags and the same
stall, grace, settle and restart logic:

  * launches `python -m posecnn_torch.train_net --resume` (with --cfg,
    --imdb, --iters, --network, --device and any other flags passed
    through) as a child process in a session of its own;
  * watches the run's `train_metrics.csv` (`core/metrics.py`: a row every
    TRAIN.DISPLAY steps) for forward progress;
  * on a stall (no new row for --stall-sec, or --warmup-sec before the
    launch's first new row) sends SIGTERM, so the Solver snapshots the step
    it reached, waits for the snapshot to land (`wait_snapshot_then_kill`),
    then SIGKILLs what is left and relaunches with --resume;
  * exits 0 when the child completes the requested steps (its metrics row
    or its final snapshot at --iters), 1 after --max-restarts, and 2 after
    two clean exits without progress short of --iters.

The run directory is the one `posecnn_torch.train_net` writes to
(`run_meta_for`: --output, or output/<EXP_DIR>/<imdb>/<network> by
`core.config.get_output_dir` and `train_net.run_dir_name`). The supervisor
itself does no device work; its child trains on --device (cuda by default).

Usage: python -m posecnn_torch.tools.supervise_train --cfg FILE.yml --imdb NAME --iters N
           [--network vgg16_convs] [--output DIR] [--stall-sec 120] [--warmup-sec 900]
           [--grace-sec 1800] [--settle-sec 90] [--max-restarts 20] [--log FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def latest_row(csv_path):
    """(step, mtime) of the metrics file's last row, or (None, None)
    without the file; (None, mtime) when its last line does not parse."""
    try:
        st = os.stat(csv_path)
    except OSError:
        return None, None
    try:
        with open(csv_path, "rb") as f:
            f.seek(max(0, st.st_size - 4096))
            lines = f.read().decode(errors="replace").strip().splitlines()
        last = lines[-1].split(",")
        return int(float(last[0])), st.st_mtime
    except (ValueError, IndexError, OSError):
        return None, st.st_mtime


def latest_ckpt(out_dir, prefix=None):
    """(step, filename) of the newest `*_iter_N.npz` snapshot, or (None,
    None). The metrics CSV gains a row only every TRAIN.DISPLAY steps, so a
    run whose --iters is not a multiple of it ends with a last row short of
    --iters: the final snapshot is the completion marker. With `prefix`,
    only snapshots of this run's TRAIN.SNAPSHOT_PREFIX count (a longer
    earlier run's snapshots in the same directory must not complete a new
    run)."""
    best, best_name = None, None
    try:
        names = os.listdir(out_dir)
    except OSError:
        return None, None
    for name in names:
        if not name.endswith(".npz") or "_iter_" not in name:
            continue
        if prefix and not name.startswith(prefix + "_iter_"):
            continue
        try:
            it = int(name.rsplit("_iter_", 1)[1].split(".")[0])
        except ValueError:
            continue
        if best is None or it > best:
            best, best_name = it, name
    return best, best_name


def latest_ckpt_iter(out_dir, prefix=None):
    return latest_ckpt(out_dir, prefix)[0]


def wait_snapshot_then_kill(child, out_dir, prefix, grace_sec, settle_sec=90.0, poll_sec=5.0, log=print):
    """After SIGTERM, give the snapshot on the signal its chance to land:
    the child exiting on its own is the clean path ("clean"); a new
    snapshot landing (written atomically, so complete) makes SIGKILL safe
    after `settle_sec` more ("snapshot-kill"); otherwise SIGKILL after the
    whole `grace_sec` ("grace-kill")."""
    pre_it = latest_ckpt_iter(out_dir, prefix)
    pre_it = -1 if pre_it is None else pre_it
    deadline = time.time() + grace_sec
    landed_at = None
    while time.time() < deadline:
        if child.poll() is not None:
            return "clean"
        cur = latest_ckpt_iter(out_dir, prefix)
        if landed_at is None and cur is not None and cur > pre_it:
            landed_at = time.time()
            log(f"[supervisor] signal snapshot landed (iter={cur}); allowing {settle_sec}s for clean exit")
        if landed_at is not None and time.time() - landed_at > settle_sec:
            break
        time.sleep(poll_sec)
    outcome = "snapshot-kill" if landed_at is not None else "grace-kill"
    log(f"[supervisor] {outcome}: SIGKILL")
    try:
        os.killpg(child.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    child.wait()
    return outcome


def run_meta_for(cfg_file, imdb_name, network, output_override):
    """(run directory, TRAIN.SNAPSHOT_PREFIX, TRAIN.SNAPSHOT_ITERS) of the
    child's run."""
    from posecnn_torch.core import config as C

    cfg = C.cfg_from_file(cfg_file) if cfg_file else C.Config()
    prefix, snap_iters = cfg.TRAIN.SNAPSHOT_PREFIX, cfg.TRAIN.SNAPSHOT_ITERS
    if output_override:
        return output_override, prefix, snap_iters
    from posecnn_torch.data.factory import get_imdb
    from posecnn_torch.train_net import run_dir_name

    return C.get_output_dir(cfg, get_imdb(imdb_name).name, run_dir_name(cfg, network)), prefix, snap_iters


def run_dir_for(cfg_file, imdb_name, network, output_override):
    return run_meta_for(cfg_file, imdb_name, network, output_override)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--imdb", required=True)
    ap.add_argument("--iters", type=int, required=True)
    ap.add_argument("--network", default="vgg16_convs", help="network name (must match the child's run dir)")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda", help="the child's device: cuda (default) or cpu")
    ap.add_argument("--stall-sec", type=float, default=120.0)
    ap.add_argument("--warmup-sec", type=float, default=900.0,
                    help="stall threshold before the launch's first new metric row")
    ap.add_argument("--grace-sec", type=float, default=1800.0,
                    help="SIGTERM->SIGKILL grace; a landed snapshot short-circuits it (--settle-sec)")
    ap.add_argument("--settle-sec", type=float, default=90.0,
                    help="extra wait for a clean exit once the signal snapshot is on disk")
    ap.add_argument("--max-restarts", type=int, default=20)
    ap.add_argument("--log", default=None, help="child stdout/stderr file")
    args, passthrough = ap.parse_known_args(argv)

    out_dir, snap_prefix, snap_iters = run_meta_for(args.cfg, args.imdb, args.network, args.output)
    csv_path = os.path.join(out_dir, "train_metrics.csv")
    print(f"[supervisor] run dir: {out_dir} (snapshots {snap_prefix}_iter_N.npz every {snap_iters})", flush=True)

    base_cmd = [sys.executable, "-m", "posecnn_torch.train_net", "--cfg", args.cfg, "--imdb", args.imdb,
                "--iters", str(args.iters), "--network", args.network, "--device", args.device,
                "--resume"] + passthrough
    if args.output:
        base_cmd += ["--output", args.output]

    logf = open(args.log, "ab", buffering=0) if args.log else None
    restarts = 0
    clean_exits_no_progress = 0
    try:
        while True:
            it0, _ = latest_row(csv_path)
            print(f"[supervisor] launch (restart {restarts}, resume from "
                  f"iter={it0 if it0 is not None else 'scratch'})", flush=True)
            child = subprocess.Popen(base_cmd, cwd=ROOT, stdout=logf or None,
                                     stderr=subprocess.STDOUT if logf else None, start_new_session=True)
            # a fresh launch pays the snapshot's restore and the kernels'
            # builds before its first row: --warmup-sec until then
            last_change = time.time()
            last_it, _ = latest_row(csv_path)
            progressed = stalled = False
            while child.poll() is None:
                time.sleep(10.0)
                it, _ = latest_row(csv_path)
                if it != last_it:
                    last_it, last_change, progressed = it, time.time(), True
                if time.time() - last_change > (args.stall_sec if progressed else args.warmup_sec):
                    stalled = True
                    break
            if stalled:
                print(f"[supervisor] stall at iter={last_it}: SIGTERM (snapshot-on-signal), grace {args.grace_sec}s",
                      flush=True)
                try:
                    os.killpg(child.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
                outcome = wait_snapshot_then_kill(child, out_dir, snap_prefix, args.grace_sec,
                                                  settle_sec=args.settle_sec,
                                                  log=lambda m: print(m, flush=True))
                print(f"[supervisor] stall handled: {outcome}", flush=True)
            else:
                rc = child.returncode
                it, _ = latest_row(csv_path)
                if rc == 0:
                    ckpt_it, ckpt_name = latest_ckpt(out_dir, snap_prefix)
                    if (it is not None and it >= args.iters) or (ckpt_it is not None and ckpt_it >= args.iters):
                        print(f"[supervisor] complete at iter={it} (ckpt={ckpt_name})", flush=True)
                        return 0
                    if not progressed:
                        # repeated clean exits without progress: done only if
                        # a snapshot came within one SNAPSHOT_ITERS of --iters
                        clean_exits_no_progress += 1
                        if clean_exits_no_progress >= 2:
                            best = max(ckpt_it or -1, it or -1)
                            if best >= args.iters - snap_iters and best >= 0:
                                print(f"[supervisor] two clean exits without CSV progress at iter={best} (within "
                                      f"one SNAPSHOT_ITERS of {args.iters}, ckpt={ckpt_name}): complete", flush=True)
                                return 0
                            print(f"[supervisor] giving up: two clean exits without progress but iter={best} is "
                                  f"short of --iters {args.iters} (ckpt={ckpt_name})", flush=True)
                            return 2
                    else:
                        clean_exits_no_progress = 0
                else:
                    clean_exits_no_progress = 0
                print(f"[supervisor] child exited rc={rc} at iter={it}", flush=True)
            restarts += 1
            if restarts > args.max_restarts:
                print("[supervisor] max restarts exceeded", flush=True)
                return 1
            time.sleep(3.0)
    finally:
        if logf is not None:
            logf.close()


if __name__ == "__main__":
    sys.exit(main())
