"""Core structures of the port: ranking, packed bit arrays, constructs, obs."""
