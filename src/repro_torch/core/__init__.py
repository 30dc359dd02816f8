"""FAME core — the paper's contribution as a composable library."""
from repro_torch.core.config import CONFIGS, MemoryConfig  # noqa: F401
from repro_torch.core.faas import FaaSPlatform, FunctionDef  # noqa: F401
from repro_torch.core.mcp import FastMCP  # noqa: F401
from repro_torch.core.runtime import FameRuntime  # noqa: F401
from repro_torch.core.telemetry import Trace, use_trace  # noqa: F401
from repro_torch.core.wrapper import fame_wrapper, wrap_server  # noqa: F401
