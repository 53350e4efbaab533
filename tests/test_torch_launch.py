"""The port's launcher, `python -m cslam_tpu_torch.launch`, as robot
processes over the C++ TCP bus, on the CPU (`--device cpu`):

- two port robots exchange descriptors and verify loop closures in a
  short mission (the counterpart of tests/test_launch_subprocess.py);
- a mixed swarm: robot 0 runs the reference's launcher, robot 1 the
  port's, on one base port with the same settings; both verify loop
  closures, so the port speaks the reference's wire protocol;
- crash recovery: one robot is killed with SIGKILL mid-mission and
  restarted from its periodic checkpoint (the counterpart of
  tests/test_crash_resume.py, with its assertions). The kill waits, under
  a deadline, for a checkpoint that holds a third of the robot's
  keyframes, never a fixed sleep. The resumed robot's run ends
  RESUME_END_MARGIN_S before its peer's (whose loop starts when its first
  checkpoint appears): a robot left with no neighbour solves its own
  graph alone, odometry only, and adopts that.

Every child runs in its own session with a hard deadline; a child past
it has its process group killed and the test fails with its output.
Ports 20500-20599 are this file's. OMP_NUM_THREADS=1 in every child:
the suite runs several workers side by side.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 220
RESUME_END_MARGIN_S = 5.0


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _robot_cmd(package, rid, n_robots, duration, poses, period, base_port,
               out_dir="", resume=False):
    cmd = [sys.executable, "-u", "-m", f"{package}.launch",
           "--robot-id", str(rid), "--robots", str(n_robots),
           "--duration", str(duration), "--sim", "--sim-poses", str(poses),
           "--sim-kf-period", str(period), "--base-port", str(base_port)]
    if package == "cslam_tpu_torch":
        cmd += ["--device", "cpu"]
    if out_dir:
        cmd += ["--json-out", os.path.join(out_dir, "metrics"),
                "--checkpoint-dir", os.path.join(out_dir, "ckpt"),
                "--checkpoint-period", "1.0"]
    return cmd + (["--resume"] if resume else [])


def _start(cmd, env, log):
    """The child in its own session, its output into the file `log`."""
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    proc.log = log
    return proc


def _output(proc):
    with open(proc.log) as f:
        return f.read()


def _kill(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait(timeout=30)


def _finish(procs, deadline_s=DEADLINE_S):
    """Each child's output once it exits; a child past the deadline has
    its group killed and fails the test."""
    try:
        for rid, p in procs.items():
            try:
                p.wait(timeout=deadline_s)
            except subprocess.TimeoutExpired:
                _kill(p)
                pytest.fail(f"robot {rid} passed its {deadline_s} s "
                            f"deadline:\n{_output(p)[-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                _kill(p)
    return {rid: _output(p) for rid, p in procs.items()}


def _done_line(out, rid):
    lines = [ln for ln in out.splitlines() if f"[r{rid}] done" in ln]
    assert lines, out[-2000:]
    line = lines[0]
    keyframes = int(line.split("done: ")[1].split(" keyframes")[0])
    n_fixed = int(line.split("keyframes, ")[1].split(" verified")[0])
    tx = int(line.split("tx=")[1].split("B")[0])
    return keyframes, n_fixed, tx


def test_launch_two_robots_sim(tmp_path):
    procs = {rid: _start(_robot_cmd("cslam_tpu_torch", rid, 2, 14, 10, 0.1,
                                    20500) + ["--json-out", str(tmp_path)],
                         _env(), tmp_path / f"robot{rid}.log")
             for rid in (0, 1)}
    outs = _finish(procs)
    for rid in (0, 1):
        assert procs[rid].returncode == 0, outs[rid][-2000:]
        keyframes, n_fixed, tx = _done_line(outs[rid], rid)
        # all keyframes ingested and loop closures verified over TCP
        assert keyframes == 10
        assert n_fixed > 0, outs[rid][-2000:]
        assert tx > 0
        with open(tmp_path / f"robot{rid}.json") as f:
            m = json.load(f)
        assert m["device"] == "cpu"
        assert not any(m["knn_launches"].values())  # no card, no kernel


def test_mixed_swarm_reference_and_port_robots(tmp_path):
    """Robot 0 on cslam_tpu (JAX on the CPU), robot 1 on the port: both
    verify loop closures over the shared TCP bus."""
    procs = {0: _start(_robot_cmd("cslam_tpu", 0, 2, 20, 10, 0.1, 20510),
                       _env(JAX_PLATFORMS="cpu"), tmp_path / "robot0.log"),
             1: _start(_robot_cmd("cslam_tpu_torch", 1, 2, 20, 10, 0.1,
                                  20510), _env(), tmp_path / "robot1.log")}
    outs = _finish(procs)
    for rid in (0, 1):
        assert procs[rid].returncode == 0, outs[rid][-2000:]
        keyframes, n_fixed, tx = _done_line(outs[rid], rid)
        assert keyframes == 10
        assert n_fixed > 0, outs[rid][-2000:]
        assert tx > 0


def _checkpoint_keyframe(manifest):
    try:
        with open(manifest) as f:
            key = json.load(f)["latest_local_key"]
    except (OSError, ValueError):  # not written yet, or being swapped
        return -1
    return -1 if key is None else key[1]


def test_sigkill_and_resume_from_checkpoint(tmp_path):
    out_dir = str(tmp_path)
    poses, period, duration, base = 30, 0.4, 42, 20520
    env = _env()
    procs = {}
    try:
        t0 = time.monotonic()
        for rid in (0, 1):
            procs[rid] = _start(_robot_cmd("cslam_tpu_torch", rid, 2,
                                           duration, poses, period, base,
                                           out_dir), env,
                                tmp_path / f"robot{rid}.log")
        # run a third of the keyframes, then kill r1 HARD
        manifest, r0_manifest = (
            os.path.join(out_dir, "ckpt", f"robot{rid}", "manifest.json")
            for rid in (1, 0))
        r0_start = None
        while _checkpoint_keyframe(manifest) < poses // 3 or \
                r0_start is None:
            if r0_start is None and os.path.exists(r0_manifest):
                r0_start = time.monotonic()
            assert procs[0].poll() is None, _output(procs[0])
            assert procs[1].poll() is None, _output(procs[1])
            assert time.monotonic() - t0 < duration, \
                "no periodic checkpoint with a third of the keyframes"
            time.sleep(0.1)
        _kill(procs[1])
        assert procs[1].returncode != 0  # died, not exited

        # restart r1 from its checkpoint for the rest of r0's mission
        rest = r0_start + duration - time.monotonic() - RESUME_END_MARGIN_S
        procs[1] = _start(_robot_cmd("cslam_tpu_torch", 1, 2, rest, poses,
                                     period, base, out_dir, resume=True),
                          env, tmp_path / "robot1_resumed.log")
    except BaseException:
        for p in procs.values():
            if p.poll() is None:
                _kill(p)
        raise
    outs = _finish(procs)
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert procs[1].returncode == 0, outs[1][-2000:]
    assert "resumed from checkpoint" in outs[1], outs[1][-2000:]

    with open(os.path.join(out_dir, "metrics", "robot1.json")) as f:
        m1 = json.load(f)
    with open(os.path.join(out_dir, "metrics", "robot0.json")) as f:
        m0 = json.load(f)

    # r1 actually restored mid-mission state (not a fresh start) ...
    assert m1["resumed_from_keyframe"] is not None
    assert m1["resumed_from_keyframe"] > 0
    # ... regained liveness and finished the keyframe stream
    assert m1["keyframes"] == poses
    # ... and contributed NEW verified loop closures after the resume
    assert m1["verified_loop_closures"] > \
        (m1["verified_loop_closures_at_resume"] or 0), m1
    # both sides converged to optimized estimates
    assert m1["optimizations"] >= 1
    assert m0["verified_loop_closures"] > 0
    assert m1["optimized_estimates"] > 3
    assert m1["ate_optimized_m"] is not None
    # optimization beats raw drifting odometry after the crash-resume
    assert m1["ate_optimized_m"] < m1["ate_odometry_m"], m1
