"""Model-side helpers of the port."""
