from .cli import main
from .utils.errors import run

if __name__ == "__main__":
    raise SystemExit(run(main))
