import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], t0=T0))
