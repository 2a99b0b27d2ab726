"""Print a preset's resolved configuration as JSON (the counterpart of
tools/print_config.py).

    python -m gedepth_tpu_torch.tools.print_config <preset>
        [--options key=value ...]

--options overrides dotted fields as `tools.train` does
(`configs.apply_options`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json


def main(argv=None):
    from gedepth_tpu_torch.configs import (
        apply_options, get_config, list_configs)

    parser = argparse.ArgumentParser(description="Print a resolved preset")
    parser.add_argument("config", choices=list_configs())
    parser.add_argument("--options", nargs="*", default=None,
                        help="dotted config overrides key=value")
    args = parser.parse_args(argv)
    cfg = apply_options(get_config(args.config), args.options)
    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))


if __name__ == "__main__":
    main()
