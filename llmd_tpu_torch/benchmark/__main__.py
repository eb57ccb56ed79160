from llmd_tpu_torch.benchmark.harness import main

if __name__ == "__main__":  # importing the package's modules runs nothing
    main()
