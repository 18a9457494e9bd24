"""Streaming file downloader with progress.

Parity target: `/root/reference/nanowakeword/utils/download_files.py:24-47`.
Used for optional assets (piper voices, pretrained encoder checkpoints);
the core framework needs no downloads.
"""

from __future__ import annotations

import os
import urllib.request

from nanowakeword_tpu.utils.logger import print_info


def download_file(url: str, target_directory: str,
                  file_size: int = None, chunk_size: int = 1024 * 256) -> str:
    """Download `url` into `target_directory`, streaming with progress.
    Returns the local path."""
    os.makedirs(target_directory, exist_ok=True)
    local_path = os.path.join(target_directory, url.split("/")[-1])
    tmp_path = local_path + ".part"

    req = urllib.request.Request(url, headers={"User-Agent": "nanowakeword"})
    with urllib.request.urlopen(req) as resp:
        total = file_size or int(resp.headers.get("Content-Length") or 0)
        done = 0
        with open(tmp_path, "wb") as f:
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                if total:
                    pct = done * 100 // total
                    print(f"\r  downloading {os.path.basename(local_path)}: "
                          f"{pct}% ({done // 1024} KiB)", end="")
        print()
    os.replace(tmp_path, local_path)
    print_info(f"Downloaded {url} -> {local_path}")
    return local_path
