"""The sharded tier: label hashing and the stream router."""
