"""Experiments of the port: measurement entry points run on the card."""
