"""Dict with attribute access (counterpart:
latentaugment_tpu/utils/util_easydict.py)."""


class EasyDict(dict):
    """A dictionary whose items are also reachable as attributes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None
