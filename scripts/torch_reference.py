"""The reference C++ binary (``baseline/bench_reference``) for the port's
reference-baseline scripts (torch_run_baseline_1m.py, torch_run_baseline_4m.py,
torch_calibrate_world.py): find it, export its inputs, run its ``build`` and
``search`` modes and parse what they print.

The tracked ``baseline/bench_reference`` is run as it is; nothing is ever
written into ``baseline/``. Where it is missing, it is built with
``baseline/Makefile``'s own rule, compiler and flags into the git-ignored
``build/reference/`` (``make -f baseline/Makefile`` run there); that needs
the reference sources the Makefile names (its ``REF``), and without them
the build exits non-zero and says so. A binary that cannot start on this
host (a missing ``libgomp``, an instruction the CPU lacks) ends the run
with its own code: there is no fallback.

Run alone, it prints the binary it would use (building it if need be) and
the host's CPU:  python scripts/torch_reference.py
"""

from __future__ import annotations

import json
import os
import platform
import re
import shutil
import signal
import subprocess
import sys
from typing import Callable, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
BASELINE_DIR = os.path.join(REPO, "baseline")
BUILD_DIR = os.path.join(REPO, "build", "reference")
EXE = "bench_reference"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class ReferenceError(RuntimeError):
    """The reference binary is missing and cannot be built, or it failed;
    ``code`` is the exit code the script should end with."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


def reference_binary(baseline_dir: str = BASELINE_DIR,
                     build_dir: str = BUILD_DIR) -> str:
    """The path of the reference binary: the tracked one in
    ``baseline_dir``, else one built earlier in ``build_dir``, else one
    built now there from ``baseline_dir/Makefile``. Raises ReferenceError
    when the build fails (the Makefile's reference sources are absent, or
    the compiler refuses)."""
    tracked = os.path.join(baseline_dir, EXE)
    if os.path.exists(tracked):
        return tracked
    built = os.path.join(build_dir, EXE)
    if os.path.exists(built):
        return built
    makefile = os.path.join(baseline_dir, "Makefile")
    if shutil.which("make") is None or not os.path.exists(makefile):
        raise ReferenceError(f"no {tracked}, and no make or {makefile} to "
                             f"build it")
    os.makedirs(build_dir, exist_ok=True)
    # the rule compiles `-Ishim` and bench_reference.cpp relative to its
    # directory: the build directory sees both through a link and VPATH
    shim = os.path.join(build_dir, "shim")
    if not os.path.lexists(shim):
        os.symlink(os.path.join(os.path.abspath(baseline_dir), "shim"), shim)
    log(f"building {built} with {makefile} ...")
    r = subprocess.run(["make", "-C", build_dir, "-f",
                        os.path.abspath(makefile),
                        f"VPATH={os.path.abspath(baseline_dir)}", EXE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        why = r.stderr.strip().splitlines()[-1:] or ["(no message)"]
        missing = "No rule to make target" in r.stderr
        raise ReferenceError(
            (f"cannot build the reference binary: the reference sources "
             f"that {makefile} names (its REF) are not here: " if missing
             else "cannot build the reference binary: ") + why[0],
            r.returncode)
    return built


def host_cpu() -> dict:
    """The host's CPU (model name, and family / model numbers, which a
    virtual machine may show where it hides the name) and core count, for a
    record of a CPU run."""
    out = {"cpu": platform.processor() or None, "cpu_family_model": None}
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read()
    except OSError:
        info = ""
    fields = {k: re.search(rf"^{k}\s*:\s*(.+)$", info, re.M)
              for k in ("model name", "cpu family", "model")}
    if fields["model name"]:
        out["cpu"] = fields["model name"].group(1).strip()
    if fields["cpu family"] and fields["model"]:
        out["cpu_family_model"] = (f"{fields['cpu family'].group(1).strip()}/"
                                   f"{fields['model'].group(1).strip()}")
    return {**out, "nproc": os.cpu_count()}


def export(path: str, fn: Callable[[], None]) -> None:
    """Write an input file once: an existing one is kept."""
    if not os.path.exists(path):
        fn()
        log(f"exported {path}")


def export_inputs(wd: str, names: dict, base, train, knn, eval_q,
                  gt_i) -> dict:
    """Write the reference's five inputs into ``wd`` under ``names`` (keys
    base, train, knn, eval, gt) with the port's `write_fbin` /
    `write_knn_ibin`, ids as int32; returns the paths by key."""
    from mysteryann_tpu_torch.io.formats import write_fbin, write_knn_ibin
    os.makedirs(wd, exist_ok=True)
    paths = {k: os.path.join(wd, v) for k, v in names.items()}
    export(paths["base"], lambda: write_fbin(paths["base"], base))
    export(paths["train"], lambda: write_fbin(paths["train"], train))
    export(paths["knn"], lambda: write_knn_ibin(
        paths["knn"], np.asarray(knn).astype(np.int32)))
    export(paths["eval"], lambda: write_fbin(paths["eval"], eval_q))
    export(paths["gt"], lambda: write_knn_ibin(
        paths["gt"], np.asarray(gt_i).astype(np.int32)))
    return paths


def _run(argv: list) -> str:
    """Run the binary; its stdout is returned and echoed to stderr. A
    failure ends as ReferenceError with the binary's exit code (128 + the
    signal's number when a signal killed it, as a shell reports it)."""
    try:
        r = subprocess.run(argv, capture_output=True, text=True)
    except OSError as e:
        raise ReferenceError(f"{argv[0]} cannot start: {e}", 126) from e
    sys.stderr.write(r.stdout + r.stderr)
    if r.returncode != 0:
        code = r.returncode
        what = f"exit code {code}"
        if code < 0:
            what = f"killed by {signal.Signals(-code).name}"
            code = 128 - code
        raise ReferenceError(f"{os.path.basename(argv[0])} {argv[1]} failed "
                             f"({what}): {r.stderr.strip()[-400:]}", code)
    return r.stdout


def build(exe: str, paths: dict, index_p: str, m_sq: int, m_pjbp: int,
          l_pjpq: int, threads: int) -> Optional[float]:
    """The reference build, as the JAX scripts run it, unless ``index_p``
    exists. Returns its BUILD_SECONDS, kept beside the index in
    ``index_p + ".build.json"`` so a later run reuses the index and still
    reports the time (None when the sidecar is not there)."""
    side = index_p + ".build.json"
    if os.path.exists(index_p):
        try:
            with open(side) as f:
                return json.load(f)["build_secs"]
        except (OSError, KeyError, ValueError):
            return None
    log(f"== reference build (M_sq={m_sq} M_pjbp={m_pjbp} L_pjpq={l_pjpq}, "
        f"{threads} thread(s)) ==")
    out = _run([exe, "build", paths["base"], paths["train"], paths["knn"],
                index_p, str(m_sq), str(m_pjbp), str(l_pjpq), str(threads)])
    m = re.search(r"BUILD_SECONDS\s+([0-9.]+)", out)
    secs = float(m.group(1)) if m else None
    with open(side, "w") as f:
        json.dump({"build_secs": secs, "threads": threads}, f)
    return secs


def search(exe: str, paths: dict, index_p: str, k: int, threads: int,
           Ls: str) -> list:
    """The reference's search sweep over ``Ls`` ("50,100,..."): its
    ``L,qps,recall`` rows, parsed."""
    log(f"== reference search sweep ({threads} thread(s)) ==")
    return parse_rows(_run([exe, "search", paths["base"], index_p,
                            paths["eval"], paths["gt"], str(k), str(threads),
                            Ls]))


def parse_rows(out: str) -> list:
    """The ``L,qps,recall`` lines of the binary's search output (its
    ``L_pq,QPS,recall`` header and anything else skipped)."""
    rows = []
    for line in out.splitlines():
        parts = line.strip().split(",")
        if len(parts) == 3 and parts[0].isdigit():
            rows.append({"L_pq": int(parts[0]), "qps": float(parts[1]),
                         "recall": float(parts[2])})
    return rows


def crossing(rows: list, target: float) -> Optional[dict]:
    """The first row (in sweep order) at or above ``target`` recall."""
    return next((r for r in rows if r["recall"] >= target), None)


def exit_on_failure(fn: Callable[[], dict]) -> dict:
    """Run a script's body; a ReferenceError ends the process with its
    code and message."""
    try:
        return fn()
    except ReferenceError as e:
        log(f"error: {e}")
        sys.exit(e.code)


def main() -> None:
    def body():
        out = {"binary": os.path.relpath(reference_binary(), REPO),
               **host_cpu()}
        print(json.dumps(out))
        return out
    exit_on_failure(body)


if __name__ == "__main__":
    main()
