"""Traffic generators by kind; each mix is a <name>.json of parameters."""
