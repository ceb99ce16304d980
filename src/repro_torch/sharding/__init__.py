"""Logical-axis sharding rules and the activation-sharding context."""
