"""Model configurations the port can train and prove (`registry`)."""
from repro_torch.configs.registry import ARCHS, get_config, smoke_config  # noqa
