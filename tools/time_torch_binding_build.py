"""Where the host compile of the kernel binding (csrc/binding.cpp) spends
its time, on a machine with the CUDA toolkit.

    python3 tools/time_torch_binding_build.py [--reps 2]

Runs the binding's own compile command (ops/_build.commands) alone, one
step at a time, each REPS times, and prints the least wall time of each:

  * the whole compile, at -O2 as the build runs it, at -O1 and at -O0;
  * the same source parsed and its templates instantiated, no code made
    (-fsyntax-only);
  * a source of the binding's #include lines alone, and of each of its
    torch and Python headers alone (-fsyntax-only), which is what the
    headers cost;
  * for comparison, torch/csrc/autograd/python_variable.h alone, the
    header the binding no longer includes.

The kernel build runs this compile beside one nvcc per .cu source
(chip_smoke.py logs each step's time); on its own it shows what the
binding's source and headers cost.  Prints the host compiler's version
first, then one line per step and a JSON line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rmi_tpu_torch import config  # noqa: E402
from rmi_tpu_torch.ops import _build  # noqa: E402

OTHER = "torch/csrc/autograd/python_variable.h"


def wall(cmd, reps):
    """Least wall seconds of ``reps`` runs of ``cmd``; raises if it fails."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        done = subprocess.run(cmd, capture_output=True, text=True)
        best = min(best, time.perf_counter() - t0)
        if done.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)}:\n{done.stdout}{done.stderr}")
    return best


def main():
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 2
    cxx = config.cxx_path()
    print(subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
          .splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        compiles, _ = _build.commands(config.nvcc_path(), cxx, tmp, os.path.join(tmp, "x.so"))
        cmd = next(c for name, c in compiles if name == _build.BINDING)
        src = str(config.CSRC_DIR / _build.BINDING)
        flags = [a for a in cmd[1:] if a not in ("-c", "-o", src) and not a.endswith(".o")]
        headers = re.findall(r"^#include <([^>]+)>", open(src).read(), re.MULTILINE)
        torch_headers = [h for h in headers if "/" in h or h == "Python.h"]

        def syntax(text, name):
            path = os.path.join(tmp, f"{name}.cpp")
            with open(path, "w") as f:
                f.write(text)
            return wall([cxx, *flags, "-fsyntax-only", path], reps)

        obj = os.path.join(tmp, "b.o")
        steps = {}
        for opt in ("-O2", "-O1", "-O0"):
            steps[f"compile {opt}"] = wall(
                [cxx, *[opt if a == "-O2" else a for a in flags], "-c", "-o", obj, src], reps)
        steps["parse and instantiate (-fsyntax-only)"] = wall(
            [cxx, *flags, "-fsyntax-only", src], reps)
        steps["its #include lines alone"] = syntax(
            "".join(f"#include <{h}>\n" for h in headers), "includes")
        for i, h in enumerate(torch_headers):
            steps[f"<{h}> alone"] = syntax(f"#include <Python.h>\n#include <{h}>\n", f"h{i}")
        steps[f"<{OTHER}> alone (not included)"] = syntax(
            f"#include <Python.h>\n#include <{OTHER}>\n", "other")
    for k, v in steps.items():
        print(f"{k}: {v:.2f} s", flush=True)
    print(json.dumps({"reps": reps, "seconds": steps}), flush=True)


if __name__ == "__main__":
    main()
