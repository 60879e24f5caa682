"""Metric logging: stdout + JSONL file + optional wandb (the PyTorch
port's own copy of ``avion_tpu.core.logging``).

Replaces the reference's wandb-centric logging
(``main_lavila_pretrain.py:254-263,895-903``) with a sink that degrades
gracefully: wandb if available and requested, always a ``log.jsonl``
in the output dir (the VideoMAE entries' ``log.txt`` JSONL pattern,
``main_videomae_pretrain.py:277-282``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, output_dir: str, use_wandb: bool = False,
                 project: str = "avion_tpu", run_name: str = "",
                 config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "log.jsonl")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(
                    project=project, name=run_name or None, config=config,
                    resume="allow", id=run_name or None,
                )
            except Exception as e:
                print(f"[logging] wandb unavailable ({e}); using JSONL only")

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        rec = {"_time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def finish(self, exit_code: int = 0):
        if self.wandb is not None:
            self.wandb.finish(exit_code=exit_code)
