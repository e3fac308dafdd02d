"""Camera refinement of the feed-forward predictions (bundle adjustment)."""
