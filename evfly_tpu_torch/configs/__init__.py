from .config import EvflyConfig, argparsing, config_device, parse_config_file

__all__ = ["EvflyConfig", "parse_config_file", "argparsing", "config_device"]
