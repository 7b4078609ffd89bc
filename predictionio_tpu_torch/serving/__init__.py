"""Prediction server."""
