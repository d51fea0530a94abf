"""HellaSwag dataset fetcher (for networked deployments).

The port's own copy of gpt2_vision_language_tpu/data/hellaswag_download.py
(stdlib only; same names and behaviour).

The reference imports a hellaswag module that downloads the dataset but
never shipped it (train_gpt2.py:10; SURVEY.md §6 defect c). Air-gapped
machines must place `hellaswag_{split}.jsonl` under $HELLASWAG_DIR by hand;
this helper downloads it where egress exists, and returns a file that is
already there untouched.
"""

from __future__ import annotations

import os
from typing import Optional

URLS = {
    "train": "https://raw.githubusercontent.com/rowanz/hellaswag/master/data/hellaswag_train.jsonl",
    "val": "https://raw.githubusercontent.com/rowanz/hellaswag/master/data/hellaswag_val.jsonl",
    "test": "https://raw.githubusercontent.com/rowanz/hellaswag/master/data/hellaswag_test.jsonl",
}


def download(split: str = "val", data_dir: Optional[str] = None) -> str:
    """Download hellaswag_{split}.jsonl into $HELLASWAG_DIR. Returns path.
    Raises on network failure (air-gapped machines: provision the file
    instead)."""
    import urllib.request

    data_dir = data_dir or os.environ.get("HELLASWAG_DIR", "hellaswag")
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"hellaswag_{split}.jsonl")
    if os.path.exists(path):
        return path
    tmp = path + ".tmp"
    with urllib.request.urlopen(URLS[split], timeout=60) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    os.replace(tmp, path)
    return path


if __name__ == "__main__":
    import sys

    print(download(sys.argv[1] if len(sys.argv) > 1 else "val"))
