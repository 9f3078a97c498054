"""Sharding rules and placements on a device mesh."""
