"""Bundled datasets (scenario text imported from the reference corpus)."""
