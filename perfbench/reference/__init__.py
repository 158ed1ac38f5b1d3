"""The plain reference and the yardstick's work formulas."""
