"""Environment investigator: report the runtime stack and device inventory.

Parity target: `/root/reference/tools/investigate.py` — prints versions and
hardware facts useful when filing issues or debugging a training host.

Usage: python tools/investigate.py
"""

import importlib
import os
import platform
import sys


def main():
    print(f"python    {sys.version.split()[0]}  ({platform.platform()})")
    print(f"cpus      {os.cpu_count()}")
    for mod in ("jax", "jaxlib", "optax", "numpy", "scipy", "msgpack",
                "yaml", "websockets"):
        try:
            m = importlib.import_module(mod)
            print(f"{mod:<9} {getattr(m, '__version__', '?')}")
        except ImportError:
            print(f"{mod:<9} MISSING")
    try:
        import jax
        print(f"devices   {jax.devices()}")
        print(f"backend   {jax.default_backend()}")
    except Exception as e:  # noqa: BLE001
        print(f"devices   unavailable ({e})")
    try:
        import psutil
        print(f"ram       {psutil.virtual_memory().total / 2**30:.1f} GiB")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
