"""``key=value`` model-parameter strings (the artifact's
``signature["model_params"]``, e.g. ``"vocab_size=100,split_tables=true"``).

Counterpart of ``elasticdl_tpu/common/args.py`` ``parse_dict_params``,
kept as the port's own copy.
"""

from __future__ import annotations


def parse_dict_params(params: str) -> dict:
    """Parse 'a=1,b=hello,c=0.5' into {'a': 1, 'b': 'hello', 'c': 0.5}."""
    result = {}
    if not params:
        return result
    for item in params.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"Malformed key=value pair: {item!r}")
        key, value = item.split("=", 1)
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        else:
            low = value.lower()
            if low in ("true", "false"):
                value = low == "true"
        result[key.strip()] = value
    return result
