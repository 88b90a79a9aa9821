"""`python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`: one run of one cell (portbench/harness.py)."""
import sys

from portbench.harness import main

if __name__ == "__main__":
    sys.exit(main())
