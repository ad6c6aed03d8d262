"""Campaign prelude for the port's tests: shrink every plan cell to 64 tokens.

``repro_torch.launch.campaign.main()`` executes this file when
``REPRO_CAMPAIGN_PRELUDE`` names it (the orchestrator's shard subprocesses
inherit the variable). The port's counterpart of ``tiny_prelude.py``: the
shape registry's ``train_4k`` and ``decode_32k`` entries are replaced in
place (every importer shares the dict), and the evaluator's and the
loop's config lookups resolve to the reduced qwen3-0.6b whatever the arch
name, so cells keep their (arch, shape) identities but all trace the same
small model. ``cell_supported`` still reads the real configs. Spawned
dry-run workers get the reduced config and cell in their payload, so the
prelude holds with any ``--workers``.

``REPRO_TEST_EVAL_SLEEP_S`` (seconds, default 0) makes every dry run
sleep first, baseline included; with ``REPRO_TEST_STRAGGLER_SHARD`` set,
only the shard whose ``REPRO_SHARD_INDEX`` (stamped by the orchestrator)
equals it sleeps. The sleep is in this process: use ``--workers 1``.
"""
import os
import time

import repro_torch.configs as C
from repro_torch.configs import get_config as _real_get, reduced
from repro_torch.configs.base import ShapeCell

C.SHAPE_BY_NAME["train_4k"] = ShapeCell("train_4k", "train", 64, 8)
C.SHAPE_BY_NAME["decode_32k"] = ShapeCell("decode_32k", "decode", 64, 4)
_tiny = reduced(_real_get("qwen3-0.6b"))

import repro_torch.core.evaluator as E  # noqa: E402
import repro_torch.core.loop as L  # noqa: E402
import repro_torch.launch.dryrun as D  # noqa: E402

for _mod in (E, L):
    _mod.get_config = lambda name: _tiny

_sleep_s = float(os.environ.get("REPRO_TEST_EVAL_SLEEP_S", "0"))
_slow = os.environ.get("REPRO_TEST_STRAGGLER_SHARD")
if _sleep_s > 0 and (_slow is None or _slow == os.environ.get("REPRO_SHARD_INDEX")):
    _real_run_cell = D.run_cell

    def _slow_run_cell(*args, **kwargs):
        time.sleep(_sleep_s)
        return _real_run_cell(*args, **kwargs)

    D.run_cell = _slow_run_cell
