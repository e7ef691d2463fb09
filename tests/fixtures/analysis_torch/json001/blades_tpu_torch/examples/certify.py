"""Fixture: JSON001. Reference counterpart: none — lint fixture."""
import json


def main():
    # VIOLATION: no top-level try/except funneling failures to one line
    print(json.dumps({"metric": "fixture", "value": 1}))


if __name__ == "__main__":
    main()
