"""Batched serving example: greedy-decode a reduced model with KV caches
through the port's serve launcher (:mod:`repro_torch.launch.serve`), on
the card unless given ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch --arch gemma3-1b
"""

import sys

from repro_torch.launch import serve


def main(argv: list[str] | None = None) -> None:
    """``serve.main`` with ``--reduced`` appended unless present."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    serve.main(argv)


if __name__ == "__main__":
    main()
