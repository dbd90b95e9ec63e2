"""Visualization: the matplotlib dashboards are in ``utils.plotting``; the
optional meshcat 3-D replay is in ``viz.meshcat_vis`` (needs meshcat)."""
