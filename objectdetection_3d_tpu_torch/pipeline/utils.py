"""Checkpoint-directory helpers: the newest checkpoint and run folder."""

import os
import re
import time
from datetime import datetime


def latest_ckpt(train_ckpt_dir):
    """Natural-sorted newest periodic checkpoint (a ``.pth`` file or a
    ``.dcp`` directory), excluding the best one."""

    def atoi(text):
        return int(text) if text.isdigit() else text

    def natural_keys(text):
        return [atoi(c) for c in re.split(r"(\d+)", text)]

    if not os.path.isdir(train_ckpt_dir):
        return None
    files = os.listdir(train_ckpt_dir)
    if not files:
        return None
    ckpt_list = [f for f in files
                 if f.endswith((".pth", ".dcp"))
                 and "ckpt_best" not in f]
    if len(ckpt_list) == 0:
        return None
    ckpt_list.sort(key=natural_keys)
    return os.path.join(train_ckpt_dir, ckpt_list[-1])


def resume_training_process(output_path):
    """Newest timestamped run directory under ``output_path`` (names end
    in ``%Y-%m-%d-%H-%M-%S``; others are skipped)."""
    versions = []
    folders = os.listdir(output_path)
    if len(folders) == 0:
        return []
    for ver in folders:
        stamp = ver.split("_")[-1]
        try:
            ts = time.mktime(
                datetime.strptime(stamp, "%Y-%m-%d-%H-%M-%S").timetuple())
        except ValueError:
            continue
        versions.append((ver, ts))
    if not versions:
        return []
    versions.sort(key=lambda tup: tup[1])
    return versions[-1][0]
