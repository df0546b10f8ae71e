"""The harness: configurations, traffic, drivers and readers."""
