"""The port's tracing plane: event schema, daemon, stack reconstruction."""
