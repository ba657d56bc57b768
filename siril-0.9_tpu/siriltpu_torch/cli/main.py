"""siriltpu_torch command-line interface.

Usage:
    python -m siriltpu_torch                          # interactive REPL
    python -m siriltpu_torch -c "load a" -c stat      # one-shot commands
    python -m siriltpu_torch -s script.ssf            # run a script file
    python -m siriltpu_torch -d DIR ...               # set working directory
    python -m siriltpu_torch --device cpu ...         # run off the card

Port of ``siriltpu.cli.main``: the same flags, plus ``--device`` (default
``cuda``), the device every verb that reaches the card runs on. Mirrors the
reference's GUI command line (src/core/command.c dispatcher) and its CLI
flags (-i initfile, -d cwd; src/main.c:176-222).
"""

from __future__ import annotations

import argparse
import os
import sys

from siriltpu_torch.cli.commands import process_command
from siriltpu_torch.cli.state import SirilState
from siriltpu_torch.core.config import Settings


def make_state(cwd: str = ".", initfile: str = "", *, device) -> SirilState:
    state = SirilState(device=device)
    if initfile:
        if initfile.endswith(".cfg"):
            # a REFERENCE siril.cfg (libconfig): import it directly
            from siriltpu_torch.core.config import from_siril_cfg
            state.settings = from_siril_cfg(initfile)
        else:
            state.settings = Settings.load(initfile)
    state.cwd = os.path.abspath(cwd)
    return state


def run_script(state: SirilState, path: str) -> int:
    rc = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rc |= process_command(state, line)
    return rc


def repl(state: SirilState) -> None:
    print("siriltpu_torch — type 'help' for commands, 'exit' to quit")
    while True:
        try:
            line = input(f"siriltpu_torch:{os.path.basename(state.cwd)}> ")
        except EOFError:
            break
        try:
            process_command(state, line)
        except SystemExit:
            break


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="siriltpu-torch")
    # reference getopt surface: -i initfile -f formats -v -d cwd
    # (src/main.c:176-222); -c/-s add the headless modes the GTK app
    # lacked
    from siriltpu_torch import __version__
    parser.add_argument("-v", "--version", action="version",
                        version=f"siriltpu_torch {__version__} "
                                "(Siril 0.9 capabilities, PyTorch + CUDA)")
    parser.add_argument("-f", "--formats", action="store_true",
                        help="print supported input formats and exit")
    parser.add_argument("-d", "--directory", default=".",
                        help="working directory")
    parser.add_argument("-i", "--initfile", default="",
                        help="settings file")
    parser.add_argument("-c", "--command", action="append", default=[],
                        help="run a command (repeatable)")
    parser.add_argument("-s", "--script", default="",
                        help="run commands from a script file")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the verbs that reach the card "
                             "(default cuda)")
    parser.add_argument("image", nargs="?", help="image to load at startup")
    args = parser.parse_args(argv)

    if args.formats:
        from siriltpu_torch.io.films import FILM_EXTENSIONS
        print("FITS (fit/fits/fts), SER v2/v3, BMP, PNM (ppm/pgm/pnm), "
              "PIC (IRIS), TIFF, JPEG, PNG, DNG (uncompressed + "
              "lossless-JPEG), films: " + "/".join(FILM_EXTENSIONS)
              + " (AVI DIB+MJPEG and MP4/MOV MJPEG natively; "
                "others need an ffmpeg-backed imageio)")
        return 0

    state = make_state(args.directory, args.initfile, device=args.device)
    if args.image:
        process_command(state, f"load {args.image}")
    rc = 0
    if args.script:
        rc = run_script(state, args.script)
    for cmd in args.command:
        rc |= process_command(state, cmd)
    if not args.script and not args.command:
        repl(state)
    return rc


if __name__ == "__main__":
    sys.exit(main())
