"""Serialization helpers (a copy of ``lvc_tpu/utils/serialize.py``).

Counterpart of the reference's ``detectron2/utils/serialize.py``
(PicklableWrapper): makes closures/lambdas safe to ship across process
boundaries (dataloader workers, multi-host launch) by serializing with
cloudpickle when available and falling back to pickle.
"""
from __future__ import annotations

import pickle

try:  # cloudpickle handles lambdas/closures; optional in this image
    import cloudpickle as _pickler
except ImportError:  # pragma: no cover
    _pickler = pickle


class PicklableWrapper:
    """Wrap an object so pickling round-trips through cloudpickle.

    Same contract as the reference: transparent __call__/__getattr__
    passthrough, cheap no-op when wrapping an already-wrapped object.
    """

    def __init__(self, obj):
        while isinstance(obj, PicklableWrapper):
            obj = obj._obj
        self._obj = obj

    def __reduce__(self):
        s = _pickler.dumps(self._obj)
        return (_unpickle_obj, (s,))

    def __call__(self, *args, **kwargs):
        return self._obj(*args, **kwargs)

    def __getattr__(self, attr):
        if attr not in ("_obj",):
            return getattr(self._obj, attr)
        return getattr(self, attr)


def _unpickle_obj(data):
    return PicklableWrapper(pickle.loads(data))
