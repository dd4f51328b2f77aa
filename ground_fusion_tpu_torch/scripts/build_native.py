"""Build the port's native ingest runtime ahead of first use.

    python -m ground_fusion_tpu_torch.scripts.build_native

Runs ``g++ -O2 -std=c++17 -shared -fPIC -pthread`` on
``ground_fusion_tpu_torch/native/src/ingest.cpp`` into
``ground_fusion_tpu_torch/_build/`` (skipped when the library of this
source and these flags is there) and prints its path. Exits with 1 when
``g++`` is missing or the build fails.
"""

import sys

from ground_fusion_tpu_torch import native


def main() -> int:
    try:
        path = native.build()
    except RuntimeError as err:
        print(err, file=sys.stderr)
        return 1
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
