"""Building the port's native libraries (the CUDA kernels with nvcc, the
event engine with the host C++ compiler) from the sources in the checkout.

A library's path is keyed by a hash of its flags and of every file it is
built from, so an edit rebuilds it. Each compiler writes a per-process
temporary that is moved into place, so concurrent processes (test workers,
ranks) never load a half-written library. A failed build raises: nothing
falls back.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path


def library_path(build_dir: Path, name: str, flags, sources) -> Path:
    """build_dir/lib{name}-{hash of flags and sources}.so"""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return Path(build_dir) / f"lib{name}-{h.hexdigest()[:12]}.so"


def compile_libraries(jobs, what: str) -> dict:
    """Run one compiler process per (name, command, target) job, all started
    together; `command` is the compiler with its flags and sources, to which
    `-o` and the temporary are appended. -> {name: compiler output}. Raises
    RuntimeError ("{what} build failed", every failure's output) if any
    compiler exits nonzero."""
    procs = []
    for name, cmd, target in jobs:
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, cmd[0], target, tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, compiler, target, tmp, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: {compiler} exit {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError(f"{what} build failed:\n" + "\n".join(failed))
    return logs
