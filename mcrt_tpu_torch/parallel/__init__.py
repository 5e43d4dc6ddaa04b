"""Rendering over several samples and, later, several devices."""
