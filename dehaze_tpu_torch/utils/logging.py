"""Run logging: an ISO-dated text log and a structured jsonl beside it
(counterpart of `dehaze_tpu/utils/logging.py`)."""

from __future__ import annotations

import datetime
import json
import os
from typing import Any


class RunLogger:
    def __init__(self, log_dir: str, echo: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.datetime.now().isoformat().replace(":", "-")
        self.txt_path = os.path.join(log_dir, f"{stamp}.txt")
        self.jsonl_path = os.path.join(log_dir, f"{stamp}.jsonl")
        self.echo = echo

    def text(self, msg: str) -> None:
        if self.echo:
            print(msg, flush=True)
        with open(self.txt_path, "a") as f:
            f.write(msg + "\n")

    def event(self, kind: str, **fields: Any) -> None:
        rec = {"t": datetime.datetime.now().isoformat(), "kind": kind,
               **fields}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
