"""How long each CUDA source of the port takes to compile.

`aule_tpu_torch/ops/_build.py` compiles every `csrc/*.cu` in its own nvcc
process, all started together, so the build lasts as long as its slowest
source under that contention.  This starts the same processes with the
same flags, prints the second at which each one ended, then compiles the
slowest four again, one at a time, and prints their times alone.  Run it
on the card's machine from the repository root (nothing is kept):

    python3 scripts/torch_nvcc_times.py
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aule_tpu_torch.ops import _build  # noqa: E402


def _cmd(nvcc, cu, obj):
    return [nvcc, *_build.NVCC_FLAGS, "-c", str(cu), "-o", obj]


def main() -> None:
    nvcc = _build._nvcc()
    cus, _ = _build._sources()
    print(f"{os.cpu_count()} cores, {len(cus)} sources", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {cu: subprocess.Popen(
            _cmd(nvcc, cu, os.path.join(tmp, cu.stem + ".o")),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for cu in cus}
        ended = {}
        while len(ended) < len(procs):
            for cu, p in procs.items():
                if cu not in ended and p.poll() is not None:
                    ended[cu] = time.perf_counter() - t0
            time.sleep(0.1)
        order = sorted(ended, key=ended.get)
        for cu in order:
            print(f"all together: {cu.name} ended at {ended[cu]:.1f} s "
                  f"(rc {procs[cu].returncode})", flush=True)
        for cu in reversed(order[-4:]):
            t1 = time.perf_counter()
            subprocess.run(_cmd(nvcc, cu, os.path.join(tmp, "alone.o")),
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, check=True)
            print(f"alone: {cu.name} {time.perf_counter() - t1:.1f} s",
                  flush=True)


if __name__ == "__main__":
    main()
