"""Sparse-table entry policies — the counterpart of
``paddle_tpu/distributed/entry_attr.py`` (Paddle ``entry_attr.py``), as it
is: configuration records that validate their arguments and serialise as
Paddle's (``_to_attr``), so scripts of the parameter-server era parse.
"""


class EntryAttr:
    def __init__(self):
        self._name = None

    def _to_attr(self):
        raise NotImplementedError

    def __repr__(self):
        return self._to_attr()


class ProbabilityEntry(EntryAttr):
    """Admit a feature with fixed probability (entry_attr.py:62)."""

    def __init__(self, probability):
        super().__init__()
        if not isinstance(probability, float):
            raise ValueError("probability must be a float in (0,1)")
        if probability <= 0 or probability >= 1:
            raise ValueError("probability must be in (0,1)")
        self._name = "probability_entry"
        self._probability = probability

    def _to_attr(self):
        return ":".join([self._name, str(self._probability)])


class CountFilterEntry(EntryAttr):
    """Admit a feature once seen >= count times (entry_attr.py:107)."""

    def __init__(self, count_filter):
        super().__init__()
        if not isinstance(count_filter, int):
            raise ValueError("count_filter must be a non-negative integer")
        if count_filter < 0:
            raise ValueError("count_filter must be a non-negative integer")
        self._name = "count_filter_entry"
        self._count_filter = count_filter

    def _to_attr(self):
        return ":".join([self._name, str(self._count_filter)])


class ShowClickEntry(EntryAttr):
    """Track show/click columns for CTR tables (entry_attr.py:155)."""

    def __init__(self, show_name, click_name):
        super().__init__()
        if not isinstance(show_name, str) or not isinstance(click_name, str):
            raise ValueError("show_name/click_name must be str")
        self._name = "show_click_entry"
        self._show_name = show_name
        self._click_name = click_name

    def _to_attr(self):
        return ":".join([self._name, self._show_name, self._click_name])
