"""Result verification and printing (a copy of
``lvc_tpu/evaluation/testing.py``; lvc/evaluation/testing.py:9-79)."""
from __future__ import annotations

import logging
import pprint
from collections import OrderedDict
from typing import Mapping

logger = logging.getLogger(__name__)


def print_csv_format(results: dict):
    """Print metrics in the reference's copy-pasteable format
    (testing.py:9-26)."""
    assert isinstance(results, OrderedDict) or isinstance(results, dict), results
    for task, res in results.items():
        important = {k: v for k, v in res.items() if "-" not in k}
        logger.info("copypaste: Task: %s", task)
        logger.info("copypaste: %s", ",".join(important.keys()))
        logger.info("copypaste: %s", ",".join(f"{v:.4f}" for v in important.values()))


def verify_results(cfg, results: dict) -> bool:
    """Compare against cfg.TEST.EXPECTED_RESULTS entries
    [task, metric, mean, tolerance] (testing.py:27-57)."""
    expected = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    ok = True
    for task, metric, expected_val, tolerance in expected:
        actual = results[task][metric]
        if not (abs(actual - expected_val) < tolerance):
            ok = False
            logger.error(
                "Result verification failed: %s/%s = %f, expected %f +/- %f",
                task, metric, actual, expected_val, tolerance,
            )
    if ok:
        logger.info("Results verification passed.")
    else:
        logger.error("Full results: %s", pprint.pformat(results))
    return ok


def flatten_results_dict(results: dict) -> dict:
    """Nested dict -> {'a/b': v} (testing.py:60-79)."""
    out = {}
    for k, v in results.items():
        if isinstance(v, Mapping):
            for kk, vv in flatten_results_dict(v).items():
                out[f"{k}/{kk}"] = vv
        else:
            out[k] = v
    return out
