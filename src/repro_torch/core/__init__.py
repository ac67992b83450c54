"""Core of the port: graphs, metrics helpers, pinned offsets, the search."""
