/* bwa-tpu-torch: native CLI front end.
 *
 * A one-shot through the Python CLI pays the interpreter start, the torch
 * import, the CUDA context, the kernel loads and the index upload.  This
 * client skips them where it can:
 *
 *   1. If a resident-engine daemon (bwa_tpu_torch/server.py) serves the
 *      command's index prefix, forward the command over its unix socket
 *      and stream the reply: no Python at all.  The request carries the
 *      client's BWA_TPU_* variables, whose route switches the daemon
 *      applies for this request only; a daemon on another device than
 *      the command's --device refuses it, and the command then runs
 *      locally (step 3).
 *   2. Otherwise run the host-only backtrack one-shots (aln on the native
 *      search, samse, sampe) in the native library's bt_cli_main, when
 *      their route switch (BWA_TPU_ALN, _SAMSE, _SAMPE) is unset or
 *      "native".  fastmap and aln on the device route are device commands
 *      and never go there.
 *   3. Otherwise exec the Python CLI (python3 -m bwa_tpu_torch.cli, or
 *      $BWA_TPU_PYTHON), with the arguments as given, --device included.
 *
 * Socket naming matches server.py: FNV-1a 64 of realpath(prefix) under
 * $BWA_TPU_DAEMON_DIR, else $TMPDIR/bwa_tpu_torch_daemon (TMPDIR: /tmp
 * when unset).  Forward guard, as cli.py's: the arguments are read with
 * the command's getopt string; the positionals go to their real paths
 * (the daemon's cwd differs); "-"/non-regular-file inputs and the options
 * that write a file (-o/-f, joined or not) run locally.
 */

#include <dlfcn.h>
#include <libgen.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

extern char **environ;

static uint64_t fnv1a64(const char *s) {
  uint64_t h = 0xCBF29CE484222325ull;
  for (; *s; ++s) {
    h ^= (uint8_t)*s;
    h *= 0x100000001B3ull;
  }
  return h;
}

/* the subcommands that can run on the daemon's warm state, each with its
 * getopt string (cli.py) and the options that write a file of their own */
static const struct {
  const char *cmd, *opts, *out;
} FWD_CMDS[] = {
    {"mem",
     "51qpaMCSPVYjuk:c:v:s:r:t:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:N:o:f:W:x:G:h:"
     "y:K:X:H:F:z:",
     "of"},
    {"fastmap", "w:l:pi:I:L:", ""},
    {"aln", "n:o:e:i:d:l:k:LR:m:t:NM:O:E:q:f:b012IYB:", "f"},
    {"samse", "hn:f:r:", "f"},
    {"sampe", "a:o:sPn:N:c:f:Ar:", "f"},
    {NULL, NULL, NULL}};

static int find_cmd(const char *cmd) {
  for (int i = 0; FWD_CMDS[i].cmd; ++i)
    if (strcmp(cmd, FWD_CMDS[i].cmd) == 0) return i;
  return -1;
}

static int has_device_flag(int argc, char **argv) {
  for (int i = 2; i < argc; ++i)
    if (strncmp(argv[i], "--device", 8) == 0) return 1;
  return 0;
}

/* the route switch a host one-shot obeys; bt_cli_main runs only the
 * default ("native") route */
static int native_route(const char *cmd) {
  const char *var = strcmp(cmd, "aln") == 0     ? "BWA_TPU_ALN"
                    : strcmp(cmd, "samse") == 0 ? "BWA_TPU_SAMSE"
                    : strcmp(cmd, "sampe") == 0 ? "BWA_TPU_SAMPE"
                                                : NULL;
  if (!var) return 0;
  const char *v = getenv(var);
  return !v || strcmp(v, "native") == 0;
}

/* backtrack one-shots run fully native (btcli.cpp bt_cli_main in the
 * shared lib, whose stable name native/build.py links next to this
 * executable).  A return of 100 means "unsupported shape, nothing
 * written": fall through to the Python CLI. */
static void try_native(int argc, char **argv) {
  if (argc < 2 || !native_route(argv[1]) || has_device_flag(argc, argv))
    return;
  if (getenv("BWA_TPU_NO_NATIVE_CLI")) return;
  char exe[PATH_MAX];
  ssize_t n = readlink("/proc/self/exe", exe, sizeof exe - 1);
  if (n <= 0) return;
  exe[n] = 0;
  char sopath[PATH_MAX + 32];
  snprintf(sopath, sizeof sopath, "%s/bwa_tpu_torch_native.so",
           dirname(exe));
  void *h = dlopen(sopath, RTLD_NOW | RTLD_LOCAL);
  if (!h) return;
  int (*entry)(int, char **) = (int (*)(int, char **))dlsym(h,
                                                             "bt_cli_main");
  if (!entry) return;
  int rc = entry(argc, argv);
  if (rc != 100) exit(rc); /* handled (0/1); 100 = fall back to Python */
}

static void run_local(int argc, char **argv) {
  try_native(argc, argv);
  char **pargv = malloc(sizeof(char *) * (argc + 4));
  int n = 0;
  const char *py = getenv("BWA_TPU_PYTHON");
  pargv[n++] = (char *)(py ? py : "python3");
  pargv[n++] = "-m";
  pargv[n++] = "bwa_tpu_torch.cli";
  for (int i = 1; i < argc; ++i) pargv[n++] = argv[i];
  pargv[n] = NULL;
  execvp(pargv[0], pargv);
  perror("bwa-tpu-torch: exec python");
  exit(127);
}

/* JSON-escape s at o (room for 6*strlen(s)+3); returns the end */
static char *jstr(const char *s, char *o) {
  *o++ = '"';
  for (; *s; ++s) {
    unsigned char c = (unsigned char)*s;
    if (c == '"' || c == '\\') {
      *o++ = '\\';
      *o++ = c;
    } else if (c < 0x20) {
      o += sprintf(o, "\\u%04x", c);
    } else {
      *o++ = c;
    }
  }
  *o++ = '"';
  *o = 0;
  return o;
}

/* request: {"argv": [...], "env": {"BWA_TPU_X": "v", ...}}\n */
static char *make_request(char **fwd, int nfwd) {
  size_t cap = 64;
  for (int i = 0; i < nfwd; ++i) cap += 6 * strlen(fwd[i]) + 8;
  for (char **e = environ; *e; ++e)
    if (strncmp(*e, "BWA_TPU_", 8) == 0) cap += 6 * strlen(*e) + 16;
  char *req = malloc(cap), *o = req;
  o += sprintf(o, "{\"argv\": [");
  for (int i = 0; i < nfwd; ++i) {
    if (i) o += sprintf(o, ", ");
    o = jstr(fwd[i], o);
  }
  o += sprintf(o, "], \"env\": {");
  int first = 1;
  for (char **e = environ; *e; ++e) {
    const char *eq = strchr(*e, '=');
    if (strncmp(*e, "BWA_TPU_", 8) != 0 || !eq) continue;
    char *name = strndup(*e, (size_t)(eq - *e));
    if (!first) o += sprintf(o, ", ");
    first = 0;
    o = jstr(name, o);
    o += sprintf(o, ": ");
    o = jstr(eq + 1, o);
    free(name);
  }
  sprintf(o, "}}\n");
  return req;
}

/* os.path.realpath of an index prefix, which need not exist as a file:
 * its directory's real path and its base name */
static int prefix_path(const char *p, char *out) {
  char *rp = realpath(p, NULL);
  if (!rp) {
    char *d = strdup(p), *b = strdup(p);
    char *dr = realpath(dirname(d), NULL);
    const char *base = basename(b);
    if (dr) {
      rp = malloc(strlen(dr) + strlen(base) + 2);
      sprintf(rp, "%s%s%s", dr, dr[strlen(dr) - 1] == '/' ? "" : "/", base);
      free(dr);
    }
    free(d);
    free(b);
    if (!rp) return 0;
  }
  snprintf(out, PATH_MAX, "%s", rp);
  free(rp);
  return 1;
}

int main(int argc, char **argv) {
  int ci = argc < 2 ? -1 : find_cmd(argv[1]);
  if (ci < 0) run_local(argc, argv);
  const char *optstr = FWD_CMDS[ci].opts, *outopts = FWD_CMDS[ci].out;

  /* scan the arguments as getopt does (cli.py strips --device first): an
   * option that writes a file (joined or not, as -ofile or -o file; mem's
   * -H with a file) runs locally; the positionals are the index prefix and
   * the inputs, each of which must be a regular file; the forwarded argv
   * gets their real paths (the daemon's cwd differs) */
  char prefix_real[PATH_MAX];
  int npos = 0, in_opts = 1;
  char **fwd = malloc(sizeof(char *) * argc); /* rewritten argv[1..] */
  int nfwd = 0;
  fwd[nfwd++] = argv[1];
  for (int i = 2; i < argc; ++i) {
    char *a = argv[i];
    if (strcmp(a, "--device") == 0 && i + 1 < argc) {
      fwd[nfwd++] = a;
      fwd[nfwd++] = argv[++i];
      continue;
    }
    if (strncmp(a, "--device=", 9) == 0) {
      fwd[nfwd++] = a;
      continue;
    }
    if (in_opts && strcmp(a, "--") == 0) {
      in_opts = 0;
      fwd[nfwd++] = a;
      continue;
    }
    if (in_opts && a[0] == '-' && a[1]) {
      fwd[nfwd++] = a;
      for (const char *c = a + 1; *c; ++c) {
        const char *o = *c != ':' ? strchr(optstr, *c) : NULL;
        if (!o || o[1] != ':') continue; /* a flag (or unknown) */
        const char *val = c[1] ? c + 1 : (i + 1 < argc ? argv[i + 1] : "");
        if (!c[1] && i + 1 < argc) fwd[nfwd++] = argv[++i];
        if (strchr(outopts, *c) || (*c == 'H' && ci == 0 && val[0] != '@'))
          run_local(argc, argv); /* a file of the client's */
        break;
      }
      continue;
    }
    in_opts = 0;
    if (npos++ == 0) {
      if (!prefix_path(a, prefix_real)) run_local(argc, argv);
      fwd[nfwd++] = prefix_real;
      continue;
    }
    struct stat st;
    char *rp;
    /* stdin ("-"), pipes and process substitution cannot be reopened by
     * the daemon */
    if (stat(a, &st) != 0 || !S_ISREG(st.st_mode) || !(rp = realpath(a, NULL)))
      run_local(argc, argv);
    fwd[nfwd++] = rp;
  }
  const char *no_daemon = getenv("BWA_TPU_NO_DAEMON");
  if (npos == 0 || (no_daemon && strcmp(no_daemon, "1") == 0))
    run_local(argc, argv);

  /* socket path */
  char dir[PATH_MAX];
  const char *d = getenv("BWA_TPU_DAEMON_DIR");
  if (d && *d) {
    snprintf(dir, sizeof dir, "%s", d);
  } else {
    const char *tmp = getenv("TMPDIR");
    snprintf(dir, sizeof dir, "%s/bwa_tpu_torch_daemon",
             tmp && *tmp ? tmp : "/tmp");
  }
  char spath[PATH_MAX + 64];
  snprintf(spath, sizeof spath, "%s/engine-%016llx.sock", dir,
           (unsigned long long)fnv1a64(prefix_real));

  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  struct sockaddr_un sa;
  memset(&sa, 0, sizeof sa);
  sa.sun_family = AF_UNIX;
  strncpy(sa.sun_path, spath, sizeof sa.sun_path - 1);
  if (fd < 0 || strlen(spath) >= sizeof sa.sun_path ||
      connect(fd, (struct sockaddr *)&sa, sizeof sa) != 0) {
    if (fd >= 0) close(fd);
    run_local(argc, argv);
  }

  char *req = make_request(fwd, nfwd);
  size_t len = strlen(req), off = 0;
  while (off < len) {
    ssize_t w = write(fd, req + off, len - off);
    if (w <= 0) {
      perror("bwa-tpu-torch: send");
      return 1;
    }
    off += (size_t)w;
  }

  /* response: JSON status line, then raw payload until EOF */
  char line[4096];
  size_t ln = 0;
  char buf[1 << 16];
  ssize_t r;
  int in_line = 1, rc = 1, saw_status = 0;
  while ((r = read(fd, buf, sizeof buf)) > 0) {
    ssize_t start = 0;
    if (in_line) {
      ssize_t i = 0;
      for (; i < r; ++i) {
        if (buf[i] == '\n') break;
        if (ln + 1 < sizeof line) line[ln++] = buf[i];
      }
      if (i == r) continue;
      line[ln] = 0;
      in_line = 0;
      start = i + 1;
      if (strstr(line, "\"refused\"")) { /* another device: run here */
        close(fd);
        fprintf(stderr, "[bwa-tpu-torch] not forwarded: %s\n", line);
        run_local(argc, argv);
      }
      if (strstr(line, "\"error\"")) {
        fprintf(stderr, "[daemon] %s\n", line);
      } else {
        const char *p = strstr(line, "\"ok\":");
        if (p) {
          rc = atoi(p + 5);
          saw_status = 1;
        }
      }
    }
    ssize_t n = r - start, done = 0;
    while (done < n) {
      ssize_t w = write(STDOUT_FILENO, buf + start + done, n - done);
      if (w <= 0) {
        perror("bwa-tpu-torch: stdout");
        return 1;
      }
      done += w;
    }
  }
  close(fd);
  return saw_status ? rc : 1;
}
