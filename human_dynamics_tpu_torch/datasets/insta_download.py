"""InstaVariety video downloader.

Counterpart of ``human_dynamics_tpu/datasets/insta_download.py`` (the
reference's datasets/instavariety/download_insta_variety.py, a 27-line
youtube-dl loop): downloads the videos listed in
InstaVariety.json with yt-dlp/youtube-dl subprocesses, skipping those
already present.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess


def downloader_binary() -> str:
    for name in ("yt-dlp", "youtube-dl"):
        if shutil.which(name):
            return name
    raise FileNotFoundError(
        "Neither yt-dlp nor youtube-dl is installed; install one to "
        "download InstaVariety."
    )


def download(json_path: str, out_dir: str) -> int:
    with open(json_path) as f:
        entries = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    binary = downloader_binary()
    ok = 0
    for entry in entries:
        url = entry["url"] if isinstance(entry, dict) else entry
        name = (
            entry.get("id")
            if isinstance(entry, dict) else url.rstrip("/").split("/")[-1]
        )
        target = os.path.join(out_dir, f"{name}.mp4")
        if os.path.exists(target):
            ok += 1
            continue
        ret = subprocess.call([binary, "-o", target, url])
        if ret == 0:
            ok += 1
        else:
            print(f"Failed: {url}")
    return ok


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--json", required=True,
                        help="InstaVariety.json url list")
    parser.add_argument("--out_dir", required=True)
    args = parser.parse_args()
    n = download(args.json, args.out_dir)
    print(f"Downloaded/present: {n}")


if __name__ == "__main__":
    main()
