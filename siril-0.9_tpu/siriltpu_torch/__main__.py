"""``python -m siriltpu_torch`` — the CLI entry point (same as the
``siriltpu-torch`` console script; reference analog: the siril binary's
command line, src/main.c)."""

from siriltpu_torch.cli.main import main

if __name__ == "__main__":
    raise SystemExit(main())
