"""List parsers (counterpart: latentaugment_tpu/utils/util_general.py:13-26)."""


def parse_comma_separated_list(s):
    """'a,b,c' -> ['a', 'b', 'c']."""
    if isinstance(s, (list, tuple)):
        return list(s)
    if s is None or s == "":
        return []
    return [x.strip() for x in str(s).split(",") if x.strip() != ""]


def parse_separated_list_comma(lst):
    """['a', 'b'] -> 'a,b'."""
    if isinstance(lst, str):
        return lst
    return ",".join(lst)
