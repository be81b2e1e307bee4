"""Rollout viewers."""

from .render import render_html  # noqa: F401
