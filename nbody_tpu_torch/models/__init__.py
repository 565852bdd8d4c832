"""Scenario solvers."""
