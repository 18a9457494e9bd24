"""Console logging: banner, step headers, info/warn/error, key-value, table.

Parity target: `/root/reference/nanowakeword/utils/logger.py` (rich-based
console API used across every layer). Falls back to plain print when `rich`
is unavailable so the core framework has zero hard UI dependencies.
"""

from __future__ import annotations

import sys

try:
    from rich.console import Console
    from rich.table import Table
    _console = Console(highlight=False)
    _HAS_RICH = True
except Exception:  # pragma: no cover
    _console = None
    _HAS_RICH = False

_step_counter = 0

BANNER = r"""
  _  _                __      __    _        __      __           _
 | \| |__ _ _ _  ___  \ \    / /_ _| |_____  \ \    / /__ _ _ __| |
 | .` / _` | ' \/ _ \  \ \/\/ / _` | / / -_)  \ \/\/ / _ \ '_/ _` |
 |_|\_\__,_|_||_\___/   \_/\_/\__,_|_\_\___|   \_/\_/\___/_| \__,_|
                                        jax  |  XLA
"""


def print_banner():
    if _HAS_RICH:
        _console.print(f"[bold cyan]{BANNER}[/bold cyan]")
    else:
        print(BANNER)


def print_step_header(title: str):
    global _step_counter
    _step_counter += 1
    line = f"  Step {_step_counter}: {title}  "
    if _HAS_RICH:
        _console.rule(f"[bold]{line}[/bold]")
    else:
        print("=" * 12 + line + "=" * 12)


def print_info(msg: str):
    if _HAS_RICH:
        _console.print(f"[cyan][INFO][/cyan] {msg}")
    else:
        print(f"[INFO] {msg}")


def print_warning(msg: str):
    if _HAS_RICH:
        _console.print(f"[yellow][WARN][/yellow] {msg}")
    else:
        print(f"[WARN] {msg}", file=sys.stderr)


def print_error(msg: str):
    if _HAS_RICH:
        _console.print(f"[bold red][ERROR][/bold red] {msg}")
    else:
        print(f"[ERROR] {msg}", file=sys.stderr)


def print_key_value(key: str, value):
    if _HAS_RICH:
        _console.print(f"  [bold]{key:<32}[/bold] {value}")
    else:
        print(f"  {key:<32} {value}")


def print_final_report_header():
    if _HAS_RICH:
        _console.rule("[bold green] Final Model Report [/bold green]")
    else:
        print("===== Final Model Report =====")


def print_table(data: dict, title: str = ""):
    if _HAS_RICH:
        table = Table(title=title or None, show_header=True)
        table.add_column("Parameter")
        table.add_column("Value")
        for k, v in data.items():
            table.add_row(str(k), str(v))
        _console.print(table)
    else:
        print(f"--- {title} ---")
        for k, v in data.items():
            print(f"  {k:<40} {v}")
