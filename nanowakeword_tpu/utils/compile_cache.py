"""JAX's persistent compilation cache, at one fixed place.

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache directory and nothing
else is set. Otherwise the cache lives at `<checkout>/.jax_cache`, a path
that is the same on every run (the path is part of what makes a cached
program findable again), listed in `.gitignore`.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CACHE_EVENTS = ("/jax/compilation_cache/cache_hits",
                "/jax/compilation_cache/cache_misses")


def checkout_cache_dir() -> str:
    """`<checkout>/.jax_cache`: the directory above the package."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; return its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        # jax reads the variable itself; setting it again would be a second
        # source of truth
        return env
    path = checkout_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class CacheCounter:
    """Counts persistent-cache hits and misses from JAX's monitoring events
    while registered."""

    def __init__(self):
        self.counts = {e: 0 for e in CACHE_EVENTS}
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_kw):
        if event in self.counts:
            self.counts[event] += 1

    @property
    def hits(self) -> int:
        return self.counts[CACHE_EVENTS[0]]

    @property
    def misses(self) -> int:
        return self.counts[CACHE_EVENTS[1]]

    def close(self):
        jax.monitoring.unregister_event_listener(self._on_event)
