"""Run one cell of the port's benchmark on this machine's card(s):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints the notes and each number compared beside its limit on standard
error, and the result as one JSON line, the last of standard output.
Exits with a code other than 0, printing no result, without enough CUDA
devices or if JAX or the JAX package was loaded."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
