"""Configuration schema and per-architecture configs."""
