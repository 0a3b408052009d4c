from .config import CfgNode, load_yaml_with_base
from .defaults import check_supported, get_cfg

__all__ = ["CfgNode", "load_yaml_with_base", "get_cfg", "check_supported"]
