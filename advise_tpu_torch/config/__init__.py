"""The config surface of the JAX package (``advise_tpu/config``), carried
as the port's own copy of ``node.py``, ``defaults.py`` and ``parser.py`` so
that the port runs without the JAX package. ``tests/test_torch_model.py``
holds the copy equal to the original: same defaults, same preset after
inference."""

from advise_tpu_torch.config.defaults import assert_and_infer_cfg, get_cfg
from advise_tpu_torch.config.node import CfgNode
from advise_tpu_torch.config.parser import load_config, parse_args

__all__ = ["CfgNode", "get_cfg", "assert_and_infer_cfg", "load_config", "parse_args"]
