"""MCP (Model Context Protocol) proxy (the port's copy of
``aigw_tpu/mcp``; reference internal/mcpproxy).

One client session multiplexed across N backend MCP servers over
streamable HTTP, with stateless-resumable encrypted composite session IDs,
aggregated/filtered tool listings, and prefix-routed tool calls.
"""

from aigw_tpu_torch.mcp.proxy import MCPProxy, MCPBackend, MCPConfig

__all__ = ["MCPBackend", "MCPConfig", "MCPProxy"]
